"""Runtime services of the port — logging, tracing, metrics, faults, the
memory ledger and the DKV, as far as the serving path reaches them.

Copies of the JAX-free modules of `h2o3_tpu/runtime/`, trimmed to what the
port uses; where the reference met the device (device-error classes, the
device-memory probe) the port reads torch instead. The rest of the
reference's runtime (the QoS gate and the compile/retrace tracker among
it) is ROADMAP queue A, item 11.
"""


def env_int(name: str, default: int) -> int:
    """Integer env knob with an empty-string-safe default (the one parser
    every H2O3_* knob shares)."""
    import os

    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def env_float(name: str, default: float) -> float:
    import os

    v = os.environ.get(name)
    return default if v in (None, "") else float(v)
