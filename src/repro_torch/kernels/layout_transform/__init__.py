from .bench import benchmark_entry
from .kernel import (LIB, chw_to_hwc8_cuda, chw_to_hwc_cuda,
                     hwc8_to_chw_cuda, hwc_to_chw_cuda, transpose_cuda)
from .ops import chw_to_hwc, chw_to_hwc8, convert, hwc8_to_chw, hwc_to_chw
from .ref import (chw_to_hwc8_ref, chw_to_hwc_ref, hwc8_to_chw_ref,
                  hwc_to_chw_ref)

__all__ = ["LIB", "benchmark_entry", "chw_to_hwc", "hwc_to_chw",
           "chw_to_hwc8", "hwc8_to_chw", "convert", "transpose_cuda",
           "chw_to_hwc_cuda", "hwc_to_chw_cuda", "chw_to_hwc8_cuda",
           "hwc8_to_chw_cuda", "chw_to_hwc_ref", "hwc_to_chw_ref",
           "chw_to_hwc8_ref", "hwc8_to_chw_ref"]
