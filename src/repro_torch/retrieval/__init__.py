"""Retriever API over pluggable index backends, in PyTorch.

    from repro_torch.retrieval import Retriever, Corpus, Query, HPCConfig

    r = Retriever(HPCConfig(k=256, p=60.0, backend="flat", rerank=32))
    state = r.build(torch.Generator(device="cuda").manual_seed(0),
                    Corpus(doc_emb, doc_mask, doc_salience))
    scores, ids = r.search(state, Query(q_emb, q_mask, q_salience), k=10)

Built-in backends: ``flat`` (exhaustive fused ADC scan over quantized
codes, the paper's main configuration), ``float_flat`` (exhaustive float
MaxSim, ColPali-Full), ``hamming`` (popcount MaxSim over binary codes),
``cascade`` (hamming -> ADC -> float funnel, budgets in
``HPCConfig.cascade``), and the two ANN routers ``ivf`` (centroid routing
over buckets, ``HPCConfig.ivf``) and ``hnsw`` (a layered small-world
graph, ``HPCConfig.hnsw``). ``Retriever.save``/``load`` write and read the
reference's index files.
"""

from repro_torch.retrieval.base import (  # noqa: F401
    Corpus,
    IndexBackend,
    Query,
    RetrieverState,
    available_backends,
    code_dtype,
    get_backend,
    register_backend,
)
from repro_torch.core.graph import HNSWConfig  # noqa: F401
from repro_torch.core.index import IVFConfig  # noqa: F401
from repro_torch.retrieval.config import CascadeConfig, HPCConfig  # noqa: F401
from repro_torch.retrieval.retriever import Retriever  # noqa: F401

# importing the backend modules installs them in the registry
from repro_torch.retrieval import (  # noqa: E402,F401
    cascade,
    flat,
    float_flat,
    hamming,
    hnsw,
    ivf,
)
