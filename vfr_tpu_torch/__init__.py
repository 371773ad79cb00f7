"""vfr_tpu_torch — the PyTorch/CUDA port of vfr_tpu (text-to-video moment
retrieval), for one NVIDIA H100.

The JAX package ``vfr_tpu`` stays the reference; this package imports
nothing of it and keeps its own copies of what it needs.  Plain tensor code
is PyTorch; the TPU's Pallas kernels on the ported path are CUDA C++
kernels under ``csrc/``, built by ``nvcc`` at first use
(``kernels/build.py``).  Entry points run on CUDA unless the caller asks
for the CPU (``--device cpu`` / ``device="cpu"``).

Ported so far, single device, for DiDeMo and Charades-STA: training
(``cli train``: the losses, optax's optimizer rules, EMA, hard-negative
mining, checkpoints and resume; the query LSTM / GRU as autograd Functions
with a hand-written BPTT), serving (``cli index`` / ``cli serve``, with
the coarse-to-fine prefilter) and evaluation (``cli eval`` per-video
localization, ``cli corpus`` corpus retrieval with the official GT ranks):
the query LSTM / GRU kernels, the fused distance + strided-bin selection
and coarse block-max kernels, the moment tower (direct and factored, mean
and max pooling).  See ROADMAP.md for what remains.
"""

__version__ = "0.1.0"

from vfr_tpu_torch.config import (  # noqa: F401
    PRESETS,
    DataConfig,
    EvalConfig,
    ExperimentConfig,
    ModelConfig,
    TrainConfig,
    get_preset,
)
