"""What ``torch_profile_train.py`` and ``torch_profile_predict.py`` share:
the card's name and power limit, and the device time of the kernels in a
``torch.profiler`` trace."""

from __future__ import annotations

import subprocess

import torch


def card() -> str:
    """``nvidia-smi``'s name and power limit of card 0, as every kept
    number carries them."""
    return subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def device_us(evt) -> float:
    """Device µs of one ``key_averages()`` entry (the attribute's name
    differs between PyTorch releases)."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def device_kernels(prof) -> list:
    """The trace's kernels that took device time, the longest first."""
    kernels = [e for e in prof.key_averages()
               if device_us(e) > 0 and e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(kernels, key=device_us, reverse=True)


def port_kernel_us(kernels, calls: int) -> dict:
    """Device µs a call (or step) of each of the port's own kernels (those
    of ``csrc/``, all in an anonymous namespace at the top level), whatever
    their rank by time."""
    out: dict = {}
    for e in kernels:
        name = e.key.removeprefix("void ")
        if name.startswith("(anonymous namespace)::"):
            short = name[len("(anonymous namespace)::"):].split("(")[0].split("<")[0]
            out[short] = out.get(short, 0.0) + device_us(e) / calls
    return out
