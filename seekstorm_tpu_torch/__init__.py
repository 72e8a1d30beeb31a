"""seekstorm_tpu_torch — the lexical serving path of seekstorm_tpu on
PyTorch, with its device kernels written by hand for NVIDIA Hopper.

The index, tokenizer, native C++ library, schema and request/result types
are the host layer of ``seekstorm_tpu`` (numpy and C++, no jax),
re-exported here.  Searches run on an explicit torch device:

    import seekstorm_tpu_torch as st
    idx = st.create_index(path, schema)
    idx.index_documents(docs); idx.commit()
    st.search_batch(idx, [st.SearchRequest(query="a b")], device="cuda")

``device="cuda"`` without CUDA raises; pass ``device="cpu"`` to run the
plain PyTorch versions of the kernels.
"""

from seekstorm_tpu.index import Index, create_index, open_index
from seekstorm_tpu.metrics import METRICS
from seekstorm_tpu.schema import (
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
from seekstorm_tpu.search import (
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
)

from .ops.wand import native_library
from .search import dense_plans, exact_pages, search, search_batch

__all__ = [
    "Index", "create_index", "open_index", "METRICS", "native_library",
    "dense_plans", "exact_pages", "BLOCK_SIZE", "AccessType",
    "ClusteringConfig", "ClusteringMode", "DocumentCompression", "FieldType",
    "FrequentwordType", "IndexMeta", "InferenceType", "LexicalSimilarity",
    "Precision", "Quantization", "QueryCompletion", "SchemaField",
    "SpellingCorrection", "StemmerType", "StopwordType", "TokenizerType",
    "VectorConfig", "VectorSimilarity", "FacetFilter", "Highlight",
    "QueryFacet", "QueryType", "Ranges", "ResultObject", "ResultSet",
    "ResultSort", "ResultType", "SearchMode", "SearchRequest", "search",
    "search_batch",
]
