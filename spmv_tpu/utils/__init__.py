from spmv_tpu.utils.timing import benchmark_spmv, BenchResult
from spmv_tpu.utils.roofline import speed_of_light, RooflineModel, device_peaks

__all__ = [
    "benchmark_spmv",
    "BenchResult",
    "speed_of_light",
    "RooflineModel",
    "device_peaks",
]
