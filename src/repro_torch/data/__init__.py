"""Data pipeline: synthetic datasets + FL partitioning."""
from repro_torch.data.synthetic import (make_classification_dataset,
                                  make_token_stream)
from repro_torch.data.partition import partition_iid, partition_noniid_shards
