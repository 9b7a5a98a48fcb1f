"""Arithmetic the metric readers share."""

from __future__ import annotations

from portbench.lib import peaks


def of_job(record: dict, job: str) -> bool:
    return record.get("job") == job


def mfu_pct(record: dict) -> float | None:
    """The counted operations of the window's units over its seconds, as
    a share of the float32 peak."""
    if "flops_per_unit" not in record or not record["units"]:
        return None
    return (100.0 * record["flops_per_unit"] * record["units"]
            / record["window_s"] / peaks.FP32_FLOP_PER_S)


def busy_roofline_pct(record: dict) -> float | None:
    """The least time of the traced units' counted work (the larger of
    operations over the peak and bytes over the bandwidth) over the
    device's busy time in the traced sub-window."""
    t = record.get("trace")
    if t is None or "flops_per_unit" not in record or t["busy_s"] <= 0:
        return None
    least = max(record["flops_per_unit"] / peaks.FP32_FLOP_PER_S,
                record["bytes_per_unit"] / peaks.HBM_BYTES_PER_S)
    return 100.0 * least * t["units"] / t["busy_s"]


def idle_pct(record: dict) -> float | None:
    t = record.get("trace")
    if t is None or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def per_unit(record: dict, key: str) -> float | None:
    t = record.get("trace")
    if t is None or not t["units"]:
        return None
    return t[key] / t["units"]


def mean_ms(values: list) -> float | None:
    return 1e3 * sum(values) / len(values) if values else None
