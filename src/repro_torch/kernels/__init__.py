"""Hand-written CUDA kernels for LUT-GEMM on Hopper, their plain PyTorch
versions, and the quantized-matmul dispatch.

- ``bcq_mm.py``       packed BCQ matmul, each group's 2^q weights built in shared memory
- ``bcq_mm_fused.py`` the same kernel over fused QKV / gate-up projections
- ``lutgemm.py``      the paper's LUT kernel (shared-memory tables)
- ``uniform_mm.py``   uniform int-q matmul on bcq_mm's group-table skeleton
- ``grouptable.py``   that skeleton's plan and launch (K1/K2, K5, K4's f32 path)
- ``dequant_mm.py``   the paper's baseline: materialise the weight, then GEMM
- ``ternary_mm.py``   ternary matmul from sign + mask planes (tensor cores for bf16)
- ``codebook_mm.py``  codebook matmul, centroid tables in shared memory
- ``flash_attn.py``   causal GQA attention with an online softmax (prefill)
- ``rglru_scan.py``   the RG-LRU recurrence over a sequence (the hybrid family)
- ``mlstm_scan.py``   the mLSTM matrix-memory recurrence (the ssm family)
- ``slstm_scan.py``   the sLSTM scalar-memory recurrence (the ssm family)
- ``expert_mm.py``    a bank of MoE experts' packed products in one launch (K12)
- ``_build.py``       nvcc build of ``csrc/*.cu`` at first use, ctypes loading
- ``_common.py``      wrapper checks, the split-k launch shape and workspace
- ``ops.py``          ``qmatmul`` / ``expert_matmul`` format dispatch, ``linear``, ``impl_mode``
- ``ref.py``          oracles

Importing this package needs neither ``nvcc`` nor a GPU.
"""

from repro_torch.kernels.bcq_mm import bcq_mm, bcq_mm_plain
from repro_torch.kernels.bcq_mm_fused import bcq_mm_fused
from repro_torch.kernels.codebook_mm import codebook_mm, codebook_mm_plain
from repro_torch.kernels.dequant_mm import (
    dequant_materialize,
    dequant_materialize_plain,
    dequant_mm,
    dequant_mm_plain,
)
from repro_torch.kernels.expert_mm import expert_mm, expert_mm_pair, expert_mm_plain
from repro_torch.kernels.flash_attn import flash_attention, flash_attention_plain
from repro_torch.kernels.lutgemm import lutgemm, lutgemm_plain
from repro_torch.kernels.mlstm_scan import mlstm_scan, mlstm_scan_plain
from repro_torch.kernels.ops import (
    current_impl_mode,
    expert_linear,
    expert_linear_pair,
    expert_matmul,
    impl_mode,
    linear,
    linear_fused,
    qmatmul,
    quantized_matmul,
    quantized_matmul_fused,
)
from repro_torch.kernels.ref import bcq_mm_ref, lutgemm_tablewise_ref
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_plain
from repro_torch.kernels.slstm_scan import slstm_scan, slstm_scan_plain
from repro_torch.kernels.ternary_mm import ternary_mm, ternary_mm_plain
from repro_torch.kernels.uniform_mm import uniform_mm, uniform_mm_plain

KERNEL_WRAPPERS = (
    bcq_mm, bcq_mm_fused, lutgemm, uniform_mm, dequant_materialize, ternary_mm, codebook_mm,
    flash_attention, rglru_scan, mlstm_scan, slstm_scan, expert_mm,
)


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0 (and ``ternary_mm``'s
    count of tensor-core calls, ``flash_attention``'s of offset launches)."""
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    ternary_mm.tc_launches = 0
    flash_attention.offset_launches = 0


def launch_counts() -> dict:
    """Kernel wrapper name → launches since the last reset, each replay of a
    captured CUDA graph included (:func:`add_counters`)."""
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


# Every count the wrappers and the dispatch keep: (object, attribute).
COUNTERS = (
    *((fn, "launches") for fn in KERNEL_WRAPPERS),
    (ternary_mm, "tc_launches"),
    (flash_attention, "offset_launches"),
    (qmatmul, "ref_calls"),
)


def counters() -> tuple:
    """The values of :data:`COUNTERS`, in order."""
    return tuple(getattr(obj, attr) for obj, attr in COUNTERS)


def set_counters(values) -> None:
    """Set :data:`COUNTERS` to ``values`` (:func:`counters`'s order)."""
    for (obj, attr), v in zip(COUNTERS, values):
        setattr(obj, attr, v)


def add_counters(delta, times: int = 1) -> None:
    """Add ``times`` × ``delta`` to :data:`COUNTERS`. A replay of a captured
    CUDA graph runs no wrapper code, so ``infer/graphs.py`` records what a
    capture counted and adds it once a replay."""
    set_counters(v + times * d for v, d in zip(counters(), delta))


# The Prometheus family each counter of :data:`COUNTERS` is exported as.
_CENSUS_FAMILIES = {
    "launches": ("kernel_launches_total", "kernel launches since the last reset_launch_counts()"),
    "tc_launches": ("kernel_tc_launches_total", "of them, ternary_mm launches on the tensor cores"),
    "offset_launches": ("kernel_offset_launches_total", "of them, flash_attention launches at q_start > 0"),
    "ref_calls": ("qmatmul_ref_calls_total", "qmatmul dispatches that took the ref oracle"),
}


def census_families() -> list:
    """The launch census as metric families for a
    :meth:`repro_torch.obs.MetricsRegistry.add_collector` collector, read
    when a scrape asks: ``[(name, "counter", help, [(labels, value), ...])]``,
    each kernel wrapper labelled ``kernel=<name>``. Every replay of a
    captured graph is in it (:func:`add_counters`), which a counter bumped
    inside the wrappers would miss; and reading it costs the hot path
    nothing."""
    families: dict = {}
    for (obj, attr), value in zip(COUNTERS, counters()):
        name, help_ = _CENSUS_FAMILIES[attr]
        labels = {} if obj is qmatmul else {"kernel": obj.__name__}
        families.setdefault(name, (name, "counter", help_, []))[3].append((labels, value))
    return list(families.values())


__all__ = [
    "COUNTERS",
    "KERNEL_WRAPPERS",
    "add_counters",
    "bcq_mm",
    "bcq_mm_fused",
    "bcq_mm_plain",
    "bcq_mm_ref",
    "census_families",
    "codebook_mm",
    "codebook_mm_plain",
    "counters",
    "current_impl_mode",
    "dequant_materialize",
    "dequant_materialize_plain",
    "dequant_mm",
    "dequant_mm_plain",
    "expert_linear",
    "expert_matmul",
    "expert_mm",
    "expert_mm_pair",
    "expert_mm_plain",
    "flash_attention",
    "flash_attention_plain",
    "impl_mode",
    "launch_counts",
    "linear",
    "linear_fused",
    "lutgemm",
    "lutgemm_plain",
    "lutgemm_tablewise_ref",
    "mlstm_scan",
    "mlstm_scan_plain",
    "qmatmul",
    "quantized_matmul",
    "quantized_matmul_fused",
    "reset_launch_counts",
    "rglru_scan",
    "rglru_scan_plain",
    "set_counters",
    "slstm_scan",
    "slstm_scan_plain",
    "ternary_mm",
    "ternary_mm_plain",
    "uniform_mm",
    "uniform_mm_plain",
]
