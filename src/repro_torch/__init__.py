"""repro_torch — the PyTorch/CUDA port of HPC-ColPali for NVIDIA Hopper.

The same module layout and public names as ``repro`` (the JAX package,
which stays the reference): each ``repro_torch.<path>`` is the counterpart
of ``repro.<path>``. Entry points that create tensors take an explicit
``device`` (default ``"cuda"``); kernel wrappers dispatch on the device of
the tensors they are given.

Subpackages:
  core/       late interaction, the streaming scan (ADC, float and
              Hamming), K-means quantization, pruning, binary codes, the
              flat, float-flat and Hamming indexes
  kernels/    hand-written CUDA kernels (csrc/*.cu), their ctypes
              wrappers and plain PyTorch versions
  retrieval/  the Retriever facade, the backend registry, `flat`,
              `float_flat`, `hamming` and the `cascade` funnel
  models/     the dense transformer and the ColPali encoder, serving and
              training (the chunked LM loss, the contrastive step)
  optim/      AdamW (float32 or int8 moments), the schedule, gradient
              compression
  ckpt/       training checkpoints in the reference's format
  train/      the guarded, checkpointing train loop
  data/       the synthetic corpora and batches, the prefetch pipeline
  serving/    the asyncio continuous-batching server and its client
  launch/     the serving and training CLIs
"""

from repro_torch.convert import (  # noqa: F401
    state_from_numpy,
    state_to,
)
from repro_torch.retrieval import (  # noqa: F401
    Corpus,
    HPCConfig,
    Query,
    Retriever,
    RetrieverState,
)

__version__ = "0.1.0"
