"""What a measurement ran on: JAX's view of the devices and the card's
name and power limit as nvidia-smi reports them (a card capped below its
maximum runs slower, so every number is printed beside both)."""
from __future__ import annotations

import subprocess


def device_record() -> dict:
    """{"platform", "kind", "count"} of JAX's devices."""
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def card_name() -> str:
    """`name, power.limit` of the first GPU (raises without nvidia-smi)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
