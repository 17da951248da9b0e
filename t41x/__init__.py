"""t41x — channelized software-defined-radio framework in JAX.

A from-scratch JAX/XLA/Pallas re-expression of the signal-processing
capabilities of the T41-EP software-defined transceiver (reference:
tmr4/T41_SDR, a Teensy 4.1 C++ firmware).  Where the reference runs one
receiver on one 600 MHz core, t41x runs thousands of channelized
receivers as a pure, jitted, shardable streaming dataflow:

    (params, state, iq_block) -> (state', audio_block, taps)

scanned over time and batched/shard_mapped over channels on a GPU mesh.

Top-level API (lazy imports keep `import t41x` light):
    t41x.Radio, t41x.RadioConfig — the user-facing radio
    t41x.RxChain, t41x.ChainSpec — the compiled receive chain
"""

from t41x import constants
from t41x.version import __version__

# float32 matmuls by default.  On the H100, "high" and DEFAULT are both
# TF32 (10-bit mantissa).  Measured on an H100 80GB HBM3 at 700 W, 256
# channels x 8 blocks, the production chain vs the plain chain at
# "highest": TF32 puts the zoom display taps 1.8-2.0 dB off (cw,
# beacon; bound 0.5 dB) and leaves cw and channelizer audio at 58 and
# 60 dB (bound 55), while "highest" costs the flagship 4% of its block
# time at 1024 channels and 12% at 4096.  An explicit user setting is
# respected.
import jax as _jax

if _jax.config.jax_default_matmul_precision is None:
    _jax.config.update("jax_default_matmul_precision", "highest")

__all__ = ["constants", "__version__", "Radio", "RadioConfig",
           "RxChain", "ChainSpec"]


def __getattr__(name):
    if name == "Radio":
        from t41x.radio import Radio
        return Radio
    if name == "RadioConfig":
        from t41x.config import RadioConfig
        return RadioConfig
    if name in ("RxChain", "ChainSpec"):
        from t41x import chain
        return getattr(chain, name)
    raise AttributeError(name)
