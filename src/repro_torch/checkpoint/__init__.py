from repro_torch.checkpoint.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.checkpoint.fl_state import (checkpoint_path,
                                             load_fl_checkpoint,
                                             run_fingerprint,
                                             save_fl_checkpoint)
