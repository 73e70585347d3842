"""Device table keyed by `jax.Device.device_kind`, and the device-derived
defaults that read it.

Every rate the compiler models (the mesh's halo-exchange cadence choice)
or reports against comes from here, with its source.  A device that is not
in the table is an error, never a default: a model built on another card's
numbers would choose silently wrong.  The `cpu` row exists only so the CPU
test suite can drive the models; its values are nominal, not measured.
"""

from __future__ import annotations

import dataclasses

H100_DATASHEET = "NVIDIA H100 Tensor Core GPU data sheet, SXM5 column"


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    kind: str
    hbm_bytes_per_s: float      # device memory bandwidth
    hbm_bytes: int              # device memory size
    link_bytes_per_s: float     # to one peer, each way
    link_latency_s: float       # per exchange, modeled
    f32_flops_per_s: float      # float32 outside the tensor cores
    source: str


DEVICES = {
    s.kind: s for s in (
        DeviceSpec(
            kind="NVIDIA H100 80GB HBM3",
            hbm_bytes_per_s=3.35e12,
            hbm_bytes=80 * 10**9,
            link_bytes_per_s=450e9,   # NVLink 900 GB/s total
            # not on the data sheet: assumed order of one NCCL
            # point-to-point launch, until a mesh cell measures it
            link_latency_s=10e-6,
            f32_flops_per_s=67e12,
            source=H100_DATASHEET + "; link latency assumed"),
        DeviceSpec(
            kind="cpu",
            hbm_bytes_per_s=50e9,
            hbm_bytes=16 * 2**30,
            link_bytes_per_s=10e9,
            link_latency_s=1e-6,
            f32_flops_per_s=100e9,
            source="nominal, for CPU tests only; not measured"),
    )
}


def device_spec(kind: str | None = None) -> DeviceSpec:
    """The table row for `kind` (default: the first JAX device's kind)."""
    if kind is None:
        import jax

        kind = jax.devices()[0].device_kind
    try:
        return DEVICES[kind]
    except KeyError:
        raise ValueError(
            f"device kind {kind!r} is not in the device table "
            f"(soda_tpu/utils/device.py; known: {sorted(DEVICES)}); add "
            f"its row with a source") from None


# Share of the device's memory limit left to XLA's temporaries (fusion
# outputs, the scan carry's second buffer) when host tiling sizes tiles.
HBM_SLACK = 0.25


def hbm_budget(device=None) -> int | None:
    """Default device-memory budget for host tiling: the limit the device
    reports (`memory_stats()["bytes_limit"]`, what JAX may allocate) less
    HBM_SLACK of it.  None when the device reports no limit (the CPU)."""
    if device is None:
        import jax

        device = jax.devices()[0]
    stats = device.memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        return None
    return int(limit * (1 - HBM_SLACK))
