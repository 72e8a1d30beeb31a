"""seekstorm_tpu_torch — the lexical, vector and hybrid serving paths of
seekstorm_tpu on PyTorch, with their device kernels written by hand for
NVIDIA Hopper.

The package is self-contained: its index, tokenizer, schema, native C++
bindings and request/result types are its own copies of the JAX package's
host modules (same on-disk index), and it imports nothing of
``seekstorm_tpu``.  An index and its searches run on an explicit torch
device:

    import seekstorm_tpu_torch as st
    idx = st.create_index(path, schema, device="cuda")
    idx.index_documents(docs); idx.commit()
    st.search_batch(idx, [st.SearchRequest(query="a b")], device="cuda")

``device="cuda"`` without CUDA raises; pass ``device="cpu"`` to run the
plain PyTorch versions of the kernels.  ``idx.attach_mesh(st.make_mesh(
["cuda:0", "cuda:1"]))`` spreads the shards over several devices (a device
may repeat: ``["cpu"] * 8`` on the CPU).
"""

from .facets import index_facets_minmax, index_string_facets
from .index import Index, create_index, open_index
from .metrics import METRICS
from .native import load as native_library
from .parallel.mesh import Mesh, make_mesh
from .schema import (
    BLOCK_SIZE,
    AccessType,
    ClusteringConfig,
    ClusteringMode,
    DocumentCompression,
    FieldType,
    FrequentwordType,
    IndexMeta,
    InferenceType,
    LexicalSimilarity,
    Precision,
    Quantization,
    QueryCompletion,
    SchemaField,
    SpellingCorrection,
    StemmerType,
    StopwordType,
    TokenizerType,
    VectorConfig,
    VectorSimilarity,
)
from .search import (
    FacetFilter,
    Highlight,
    QueryFacet,
    QueryType,
    Ranges,
    ResultObject,
    ResultSet,
    ResultSort,
    ResultType,
    SearchMode,
    SearchRequest,
    dense_plans,
    exact_pages,
    join_plans,
    search,
    search_batch,
    wand_inputs,
)

__version__ = "0.1.0"

__all__ = [
    "Index", "create_index", "open_index", "METRICS", "native_library",
    "Mesh", "make_mesh",
    "dense_plans", "exact_pages", "join_plans", "wand_inputs", "BLOCK_SIZE",
    "AccessType",
    "ClusteringConfig", "ClusteringMode", "DocumentCompression", "FieldType",
    "FrequentwordType", "IndexMeta", "InferenceType", "LexicalSimilarity",
    "Precision", "Quantization", "QueryCompletion", "SchemaField",
    "SpellingCorrection", "StemmerType", "StopwordType", "TokenizerType",
    "VectorConfig", "VectorSimilarity", "FacetFilter", "Highlight",
    "QueryFacet", "QueryType", "Ranges", "ResultObject", "ResultSet",
    "ResultSort", "ResultType", "SearchMode", "SearchRequest", "search",
    "search_batch", "index_string_facets", "index_facets_minmax",
]
