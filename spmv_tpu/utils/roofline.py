"""Roofline model: the byte floor of memory-bound SpMV.

CSR SpMV moves, per nonzero, at least Ax (4 B fp32) + Aj (4 B int32) +
an x-gather (4 B amortized), plus per row Ap (4 B) + y (4 B)
(BASELINE.md worked model). Its least time is those bytes over the
device's memory bandwidth; a kernel's share of that floor is its
roofline share.
"""

from __future__ import annotations

import dataclasses

import jax

# Published peaks by `device_kind` (NVIDIA H100 SXM5 data sheet: 80 GB
# of HBM3 at 3.35 TB/s). They assume the card's full 700 W power limit;
# report a share of them beside the card's actual limit.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "hbm_gb": 80.0},
}


def device_peaks(device_kind: str | None = None) -> dict:
    """Published peaks of a device kind (default: the first device).
    A device that is not in the table is an error, not a default."""
    if device_kind is None:
        device_kind = jax.devices()[0].device_kind
    try:
        return DEVICE_PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add it "
            f"to spmv_tpu.utils.roofline.DEVICE_PEAKS with its source"
        ) from None


@dataclasses.dataclass
class RooflineModel:
    device_kind: str
    hbm_gbps: float
    bytes_per_nnz: float
    bytes_per_row: float

    def floor_s(self, nnz: int, n_rows: int) -> float:
        """Least time: the bytes SpMV must move over peak bandwidth."""
        return (nnz * self.bytes_per_nnz + n_rows * self.bytes_per_row) / (
            self.hbm_gbps * 1e9)


def speed_of_light(
    value_bytes: int = 4,
    index_bytes: int = 4,
    offset_bytes: int = 4,
    device_kind: str | None = None,
) -> RooflineModel:
    if device_kind is None:
        device_kind = jax.devices()[0].device_kind
    return RooflineModel(
        device_kind=device_kind,
        hbm_gbps=device_peaks(device_kind)["hbm_gbps"],
        bytes_per_nnz=value_bytes + index_bytes + value_bytes,  # Ax + Aj + x
        bytes_per_row=offset_bytes + value_bytes,  # Ap + y
    )
