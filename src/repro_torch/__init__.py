"""repro_torch — the PyTorch/CUDA port of HPC-ColPali for NVIDIA Hopper.

The same module layout and public names as ``repro`` (the JAX package,
which stays the reference): each ``repro_torch.<path>`` is the counterpart
of ``repro.<path>``. Entry points that create tensors take an explicit
``device`` (default ``"cuda"``); kernel wrappers dispatch on the device of
the tensors they are given.

Subpackages:
  core/       late interaction, the streaming ADC scan, K-means
              quantization, pruning, the flat index
  kernels/    hand-written CUDA kernels (csrc/*.cu), their ctypes
              wrappers and plain PyTorch versions
  retrieval/  the Retriever facade, the backend registry, `flat`
  data/       the synthetic retrieval corpus
  serving/    the asyncio continuous-batching server and its client
  launch/     the serving CLI
"""

from repro_torch.convert import state_from_numpy  # noqa: F401
from repro_torch.retrieval import (  # noqa: F401
    Corpus,
    HPCConfig,
    Query,
    Retriever,
    RetrieverState,
)

__version__ = "0.1.0"
