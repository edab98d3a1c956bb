"""Gradient compressors and the quantized row-span codec (port of
``repro.compression``)."""
from repro_torch.compression.sparse import (  # noqa: F401
    BLOCK, SparseGrad, compress_tree, decompress_tree, dense_nbytes,
    k_for, randomk_compress, sparse_add, topk_compress, topk_decompress,
    tree_nbytes,
)
from repro_torch.compression.quant import (  # noqa: F401
    QuantGrad, quant_compress, quant_decompress,
)
from repro_torch.compression.error_feedback import (  # noqa: F401
    ef_compress_tree, ef_init,
)
from repro_torch.compression.quant_span import (  # noqa: F401
    DIFF_QUANTS, QUANT_METER, QuantMeter, QuantSpan, quant_bits,
)
