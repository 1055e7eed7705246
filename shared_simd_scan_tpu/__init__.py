"""shared_simd_scan_tpu — a bit-packed columnar scan engine for the GPU.

JAX/XLA/Pallas (Triton) implementation with the capabilities of the C++
SSE/AVX reference RRr89/Shared_SIMD_Scan (see SURVEY.md): pack integers at
bit widths 1..31, vectorized decompress, and shared scans evaluating many
equality predicates in one bandwidth-bound pass, with data-parallel column
sharding across a device mesh.
"""

from shared_simd_scan_tpu.layout import (  # noqa: F401
    PackedColumn,
    DeviceColumn,
    pack,
    pack_device,
    to_device,
    to_canonical,
    packed_nbytes,
    unpack_schedule,
)
from shared_simd_scan_tpu import bitvector  # noqa: F401
from shared_simd_scan_tpu import io  # noqa: F401
from shared_simd_scan_tpu import query  # noqa: F401
from shared_simd_scan_tpu import stats  # noqa: F401
from shared_simd_scan_tpu import forcol  # noqa: F401
from shared_simd_scan_tpu import dictcol  # noqa: F401
from shared_simd_scan_tpu import nullable  # noqa: F401
from shared_simd_scan_tpu import zonemap  # noqa: F401
from shared_simd_scan_tpu.ops.scan import (  # noqa: F401
    scan_device,
    shared_scan_device,
    shared_scan_linear_device,
    interval_scan_device,
    range_scan_device,
    histogram_device,
)
from shared_simd_scan_tpu.ops.aggregate import (  # noqa: F401
    aggregate_scan_device,
    masked_aggregate_device,
    minmax_scan_device,
)
from shared_simd_scan_tpu.ops.member import (  # noqa: F401
    member_scan_device,
)
from shared_simd_scan_tpu.ops.conj import (  # noqa: F401
    conj_range_scan_device,
    conj_eq_scan_device,
)
from shared_simd_scan_tpu.ops.unpack import (  # noqa: F401
    pack_device_kernel,
    unpack_device,
)

__version__ = "0.1.0"
