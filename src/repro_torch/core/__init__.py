"""RawArray (.ra) — the paper's archival format, as the framework's data plane.

Public API mirrors the paper's reference implementations::

    import repro_torch.core as ra
    ra.write("x.ra", arr)
    arr = ra.read("x.ra")
    m = ra.memmap("x.ra")          # zero-copy
"""

from . import codec
from . import engine
from . import quant
from . import stats
from .header import Header, decode_header, read_header
from .io import (
    RaWriter,
    append_metadata,
    header_of,
    is_url,
    join_path,
    memmap,
    memmap_slice,
    nbytes_on_disk,
    read,
    read_into,
    read_metadata,
    read_quant_metadata,
    read_stats,
    write,
    write_like,
)
from .stats import (
    ChunkStats,
    Expr,
    StatsAccumulator,
    col,
    compute_stats,
    split_stats,
    stats_supported,
)
from .quant import QuantInfo, decode_quant_metadata, quant_params, resolve_quant_spec
from .sharded import (
    ShardedWriter,
    ShardIndex,
    load_index,
    read_sharded,
    read_slice,
    read_slice_naive,
    write_sharded,
)
from .spec import (
    ELTYPE_BRAIN,
    ELTYPE_COMPLEX,
    ELTYPE_FLOAT,
    ELTYPE_INT,
    ELTYPE_STRUCT,
    ELTYPE_UINT,
    FLAG_BIG_ENDIAN,
    FLAG_CHUNKED,
    FLAG_CRC32_TRAILER,
    FLAG_ZLIB,
    MAGIC,
    MAGIC_BYTES,
    RawArrayError,
)

__all__ = [
    "ChunkStats",
    "Expr",
    "Header",
    "QuantInfo",
    "StatsAccumulator",
    "codec",
    "col",
    "compute_stats",
    "read_stats",
    "split_stats",
    "stats",
    "stats_supported",
    "decode_quant_metadata",
    "engine",
    "quant",
    "quant_params",
    "read_quant_metadata",
    "resolve_quant_spec",
    "read_header",
    "decode_header",
    "read",
    "read_into",
    "write",
    "RaWriter",
    "ShardedWriter",
    "memmap",
    "memmap_slice",
    "read_metadata",
    "append_metadata",
    "header_of",
    "is_url",
    "join_path",
    "write_like",
    "nbytes_on_disk",
    "write_sharded",
    "read_sharded",
    "read_slice",
    "read_slice_naive",
    "load_index",
    "ShardIndex",
    "MAGIC",
    "MAGIC_BYTES",
    "RawArrayError",
    "ELTYPE_STRUCT",
    "ELTYPE_INT",
    "ELTYPE_UINT",
    "ELTYPE_FLOAT",
    "ELTYPE_COMPLEX",
    "ELTYPE_BRAIN",
    "FLAG_BIG_ENDIAN",
    "FLAG_CHUNKED",
    "FLAG_CRC32_TRAILER",
    "FLAG_ZLIB",
]
