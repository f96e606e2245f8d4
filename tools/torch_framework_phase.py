#!/usr/bin/env python3
"""chip_smoke.py's phase 48 alone, after building the kernels: the
Paddle-style Tensor and its op surface on the card (the LLaMA-2-7B and
ERNIE-3.0-base layers written with _C_ops against the port's models, the
flash launches they make, the op sweep on CUDA Tensors against CPU
Tensors). The quickest way to re-run the phase's gates.

    python3 tools/torch_framework_phase.py

Needs an NVIDIA card.
"""

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402


def main():
    from paddle_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    cs._LAP_CLOCK[0] = time.perf_counter()
    cs.log(f"device: {cs.gpu_line()}")
    _build.library()
    cs.lap("build")
    cs.framework_phase()
    cs.lap("phase 48")
    cs.log(f"time by part (s): {cs._LAPS}")
    cs.log("phase 48: ok")


if __name__ == "__main__":
    main()
