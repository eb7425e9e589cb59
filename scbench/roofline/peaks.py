"""Peaks of one NVIDIA H100 SXM (80 GB HBM3).

Published (NVIDIA H100 datasheet, SXM, at the 700 W limit): the HBM
bandwidth.  Derived: the int32 issue rate, 64 int32 operations (add,
logic, shift, funnel shift, compare) per clock per SM on compute
capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
throughput), times the SM count and the maximum SM clock, both read from
the card."""
from __future__ import annotations

import functools
import subprocess

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_CLOCK_PER_SM = 64


def int32_ops_per_s(sms: int, max_sm_mhz: float) -> float:
    """The int32 issue rate of a card with ``sms`` SMs at ``max_sm_mhz``."""
    return INT32_OPS_PER_CLOCK_PER_SM * sms * max_sm_mhz * 1e6


@functools.cache
def card_int32_ops_per_s() -> float:
    """The int32 issue rate of card 0: its SM count from torch, its maximum
    SM clock from ``nvidia-smi``."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip())
    return int32_ops_per_s(sms, mhz)


def least_time_s(n_bytes: float, n_ops: float, ops_per_s: float) -> float:
    """The least time the card can take for the work: bytes over HBM
    bandwidth or operations over their peak, whichever is longer."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s)
