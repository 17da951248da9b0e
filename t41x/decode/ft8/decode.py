"""FT8 decoder orchestration.

Device side: waterfall -> vectorized Costas sync -> batched soft-bit
extraction -> candidate-parallel LDPC BP (one jitted pipeline).
Host side: CRC-14 check, 77-bit unpacking, dedupe — the branchy tail of
the reference's `ft8_decode` (tmr4/T41_SDR `ft8.cpp:727-887`).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from t41x.decode.ft8 import crc, ldpc, message, sync, waterfall
from t41x.decode.ft8.tables import GRAY


@dataclass
class Decoded:
    text: str
    score: float
    time_offset: int
    freq_hz: float
    bits77: np.ndarray
    snr_db: float = 0.0        # calibrated estimate, WSJT-X 2.5 kHz conv.
    distance_km: float | None = None  # great-circle to the msg grid


# Score -> SNR calibration (the reference's analog is
# SNR = (score-160)/6 on ITS byte-waterfall score scale, ft8.cpp:874).
# t41x's fit comes from the clean-channel sensitivity sweep
# (tools/ft8_sensitivity.py, FT8_SENS.json): mean sync score of decoded
# signals vs true synthetic SNR in the 2.5 kHz bandwidth convention,
# least-squares over -18..-10 dB with the rectangular-window waterfall.
SNR_SLOPE = 0.2058
SNR_INTERCEPT = -31.15


def score_to_snr_db(score: float) -> float:
    """Calibrated per-decode SNR estimate from the sync score, clamped
    to the plausible FT8 reporting range like WSJT-X's -24..+49."""
    return float(np.clip(SNR_SLOPE * score + SNR_INTERCEPT, -24.0, 49.0))


def grid_of_message(text: str) -> str | None:
    """The 4-char Maidenhead grid of a standard message, if it carries
    one (reference: ft8_decode unpacks field3 and calls Target_Distance
    when it looks like a grid, ft8.cpp:830-874)."""
    parts = text.strip().split()
    if not parts:
        return None
    g = parts[-1]
    if (len(g) == 4 and "A" <= g[0] <= "R" and "A" <= g[1] <= "R"
            and g[2].isdigit() and g[3].isdigit() and g != "RR73"):
        return g
    return None


def extract_llrs(wf: jnp.ndarray, cands: sync.Candidates,
                 max_time_pad: int = 7):
    """Soft bits for each candidate (reference `extract_likelihood` +
    `decode_symbol`, `ft8.cpp:320-332,424-463`), batched over candidates.

    wf: (n_slots, 2, 2, n_bins).  Returns (K, 174) normalized LLRs.
    """
    pad = max_time_pad
    wfp = jnp.pad(wf, ((pad, pad), (0, 0), (0, 0), (0, 0)))

    k_data = np.arange(58)
    sym_idx = np.where(k_data < 29, k_data + 7, k_data + 14)  # skip sync

    slots = cands.time_offset[:, None] + pad + jnp.asarray(sym_idx)  # (K,58)
    # gather 8 tone bins per data symbol: (K, 58, 8)
    bins = cands.freq_offset[:, None, None] + jnp.arange(8)[None, None, :]
    p8 = wfp[slots[..., None], cands.time_sub[:, None, None],
             cands.freq_sub[:, None, None], bins]

    gray = jnp.asarray(GRAY)
    s2 = jnp.take_along_axis(
        p8, jnp.broadcast_to(gray, p8.shape), axis=-1)  # s2[j]=p8[gray[j]]

    def max_over(idx):
        return jnp.max(s2[..., jnp.asarray(idx)], axis=-1)

    b0 = max_over([4, 5, 6, 7]) - max_over([0, 1, 2, 3])
    b1 = max_over([2, 3, 6, 7]) - max_over([0, 1, 4, 5])
    b2 = max_over([1, 3, 5, 7]) - max_over([0, 2, 4, 6])
    llr = jnp.stack([b0, b1, b2], axis=-1).reshape(b0.shape[0], -1)  # (K,174)

    # variance normalization to sigma=4 (ft8.cpp:451-462)
    mean = jnp.mean(llr, axis=-1, keepdims=True)
    var = jnp.mean(llr * llr, axis=-1, keepdims=True) - mean * mean
    return llr * jnp.sqrt(16.0 / jnp.maximum(var, 1e-12))


def _device_pipeline(audio, k_candidates: int, bp_iters: int):
    wf = waterfall.compute_waterfall(audio)
    cands = sync.find_candidates(wf, k_candidates)
    llrs = extract_llrs(wf, cands)
    result = ldpc.bp_decode(llrs, bp_iters)
    return cands, result


_jit_pipeline = jax.jit(_device_pipeline, static_argnums=(1, 2))


def _wf_and_pool(audio, k_pool: int):
    wf = waterfall.compute_waterfall(audio)
    return wf, sync.find_candidates(wf, k_pool)


def _llr_bp(wf, cands, bp_iters: int):
    llrs = extract_llrs(wf, cands)
    return ldpc.bp_decode(llrs, bp_iters)


_jit_wf_pool = jax.jit(_wf_and_pool, static_argnums=1)
_jit_llr_bp = jax.jit(_llr_bp, static_argnums=2)

# Candidate score floor: the reference rejects sync candidates scoring
# below 40 (`find_sync` threshold, `ft8.cpp:374`).  t41x's score scale
# (mean over the 21 Costas symbols of 8*P[tone]-sum(P), dB waterfall)
# was calibrated against synthetic slots AT THE DEFAULT GEOMETRY
# (rate=24000, base_bin_hz=TONE_SPACING, rectangular window): pure-noise
# slots top out around 38, real signals at the -18 dB decode threshold
# score ~57-64 (FT8_SENS.json); heavily FADED signals can dip to ~33
# near threshold — the floor trades those against noise-pool BP work.  A
# different rate/base_bin_hz shifts the per-bin noise power and with it
# the score scale, so the adaptive path disables the floor (decodes the
# full pool) when the geometry is non-default — see decode_audio.
SCORE_FLOOR = 40.0
_K_POOL = 96
_K_BUCKETS = (12, 24, 48, 96)


def decode_audio(audio: np.ndarray, k_candidates: int | None = None,
                 bp_iters: int = 25, rate: float = 24000.0,
                 base_bin_hz: float = waterfall.TONE_SPACING,
                 hashes: message.CallHashTable | None = None,
                 score_floor: float = SCORE_FLOOR,
                 my_grid: str | None = None) -> list[Decoded]:
    """Demodulated USB audio (15 s slot at 24 kHz) -> decoded messages.

    k_candidates=None (default) adapts the candidate count to band
    occupancy: sync scores for a 96-deep pool are computed once, the
    score floor discards noise-level candidates, and LDPC runs on the
    smallest static bucket (12/24/48/96) covering the survivors — a
    quiet band costs 12 BP decodes, a crowded one gets 96 (the
    reference is fixed at 20, `ft8.cpp:64`).  Pass an int to force a
    fixed candidate count.

    Pass a `CallHashTable` kept across slots to resolve `<hashed>`
    calls in type-4 messages.  Pass `my_grid` (the station locator,
    config.my_grid) to get `distance_km` on decodes that carry a grid
    (reference `set_Station_Coordinates` + `Target_Distance`,
    locator.cpp:30-45)."""
    if k_candidates is not None:
        cands, result = _jit_pipeline(jnp.asarray(audio, jnp.float32),
                                      k_candidates, bp_iters)
    else:
        if (rate, base_bin_hz) != (24000.0, waterfall.TONE_SPACING) \
                and score_floor == SCORE_FLOOR:
            # the default floor is calibrated for the default waterfall
            # geometry only; on a non-default geometry silently
            # returning [] would be wrong — decode the full pool instead
            score_floor = -np.inf
        wf, pool = _jit_wf_pool(jnp.asarray(audio, jnp.float32), _K_POOL)
        pool_scores = np.asarray(pool.score)
        n_above = int(np.sum(pool_scores >= score_floor))
        if n_above == 0:
            return []
        k = next((b for b in _K_BUCKETS if b >= n_above), _K_POOL)
        cands = jax.tree.map(lambda a: a[:k], pool)
        result = _jit_llr_bp(wf, cands, bp_iters)

    errors = np.asarray(result.errors)
    bits = np.asarray(result.bits)
    scores = np.asarray(cands.score)
    dts = np.asarray(cands.time_offset)
    dfs = np.asarray(cands.freq_offset)
    fsub = np.asarray(cands.freq_sub)

    out: list[Decoded] = []
    seen: set[str] = set()
    for i in np.argsort(-scores):
        if errors[i] != 0:
            continue
        b = np.asarray(bits[i]).astype(np.uint8)
        if not crc.check_crc(b[:91]):
            continue
        text = message.unpack77(b[:77], hashes)
        if text in seen:
            continue
        seen.add(text)
        dist = None
        if my_grid:
            g = grid_of_message(text)
            if g is not None:
                from t41x.decode import locator

                dist = round(locator.distance_km(my_grid, g), 0)
        out.append(Decoded(
            text=text,
            score=float(scores[i]),
            time_offset=int(dts[i]),
            freq_hz=float(dfs[i] * base_bin_hz + fsub[i] * base_bin_hz / 2),
            bits77=b[:77],
            snr_db=score_to_snr_db(float(scores[i])),
            distance_km=dist,
        ))
    return out
