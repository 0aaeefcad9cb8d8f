"""Batched serving example on the PyTorch / CUDA port: prefill + greedy
decode with ring-buffer KV caches (and the Mamba-2 conv / SSM states, or
whisper's cross caches over its encoded frames) on a reduced assigned
arch.

  PYTHONPATH=src python examples/serve_decode_torch.py --arch hymba-1.5b
  PYTHONPATH=src python examples/serve_decode_torch.py \
      --arch mamba2-370m --device cpu
  PYTHONPATH=src python examples/serve_decode_torch.py --arch whisper-small
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.serve import main

if __name__ == "__main__":
    main()
