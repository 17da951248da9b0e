"""Streaming IIR biquads (JAX).

Re-expression of the CMSIS biquad cascades the reference uses everywhere
(`arm_biquad_cascade_df2T_f32` / `_df1_f32`: DC block `Process.cpp:127`,
AM lowpass `Process.cpp:705`, CW audio filters `Process.cpp:882-912`,
EQ bands `Filter.cpp:117-165`, Zoom-FFT pre-filters `FFT.cpp:86-90`).

Direct-form II transposed as a `lax.scan` over samples with a 2-element
state per stage; channels ride a leading batch axis so one scan serves
the whole channel batch (the per-sample dependency is unavoidable for
IIR, but the per-step work is a fat vector op across channels).
Coefficients use the standard convention b=[b0,b1,b2], a=[1,a1,a2]:
    y = b0 x + s1;  s1' = b1 x - a1 y + s2;  s2' = b2 x - a2 y
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def biquad_state(channels: tuple[int, ...] = (), stages: int = 1,
                 dtype=np.float32) -> np.ndarray:
    """(..., stages, 2) df2T state (host array; see fir.fir_state)."""
    return np.zeros(channels + (stages, 2), np.dtype(dtype).name)


def biquad_apply(state: jnp.ndarray, x: jnp.ndarray, b: jnp.ndarray,
                 a: jnp.ndarray):
    """Apply a cascade of biquad stages to a block.

    state: (..., S, 2)   x: (..., N)
    b: (S, 3)  a: (S, 3) with a[:,0]==1
    Returns (new_state, y).
    """
    b = jnp.atleast_2d(jnp.asarray(b, x.dtype))
    a = jnp.atleast_2d(jnp.asarray(a, x.dtype))

    def per_sample(s, xn):
        # xn: (...,) one sample across channels; s: (..., S, 2)
        def stage(carry, inputs):
            v, s_all = carry  # v: current sample through cascade
            idx = inputs
            s1 = s_all[..., idx, 0]
            s2 = s_all[..., idx, 1]
            y = b[idx, 0] * v + s1
            ns1 = b[idx, 1] * v - a[idx, 1] * y + s2
            ns2 = b[idx, 2] * v - a[idx, 2] * y
            s_all = s_all.at[..., idx, 0].set(ns1)
            s_all = s_all.at[..., idx, 1].set(ns2)
            return (y, s_all), None

        (y, s), _ = jax.lax.scan(stage, (xn, s), jnp.arange(b.shape[0]))
        return s, y

    new_state, y = jax.lax.scan(per_sample, state, jnp.moveaxis(x, -1, 0))
    return new_state, jnp.moveaxis(y, 0, -1)


def _normal_form_powers(a1: float, a2: float, k: np.ndarray, K: int,
                        P: np.ndarray):
    """Balanced, well-conditioned realization of one biquad stage and
    its chunk powers A_n^0..A_n^K (float64).

    Returns (An_pows (K+1,2,2), Bn (2,), Cn (2,)) with
    H(z) = b0 + Cn (zI - An)^-1 Bn identical to the df2T companion
    system (A=[[-a1,1],[-a2,0]], B=k, C=[1,0]).  Complex pole pairs use
    the rotation form (A_n^m = r^m * rot(m*theta), closed form — f32
    rounding perturbs its eigenvalues by ~1e-7 where the companion
    form's A^K was off by ~3e-2 for the DC blocker); distinct real
    poles use the diagonal form; repeated/defective poles fall back to
    the companion powers `P` (bounded for the filters shipped here).
    """
    C = np.array([1.0, 0.0])
    disc = a1 * a1 - 4.0 * a2
    if disc < -1e-30:                      # complex pair -> rotation
        p = (-a1 + 1j * np.sqrt(-disc)) / 2.0
        r, th = abs(p), np.angle(p)
        v = np.array([1.0 + 0j, p + a1])   # eigenvector of companion A
        T = np.stack([v.real, v.imag], axis=1)
        Bn = np.linalg.inv(T) @ k
        Cn = C @ T
        alpha = np.sqrt(np.linalg.norm(Bn)
                        / max(np.linalg.norm(Cn), 1e-300))
        Bn, Cn = Bn / alpha, Cn * alpha
        m = np.arange(K + 1)
        c, s = np.cos(m * th), np.sin(m * th)
        rm = r ** m
        An_pows = (np.stack([np.stack([c, s], -1),
                             np.stack([-s, c], -1)], axis=-2)
                   * rm[:, None, None])
        return An_pows, Bn, Cn
    p1 = (-a1 + np.sqrt(max(disc, 0.0))) / 2.0
    p2 = (-a1 - np.sqrt(max(disc, 0.0))) / 2.0
    if abs(p1 - p2) > 1e-9 * max(1.0, abs(p1)):  # real distinct -> diag
        T = np.array([[1.0, 1.0], [p1 + a1, p2 + a1]])
        Bn = np.linalg.inv(T) @ k
        Cn = C @ T
        al = np.sqrt(np.maximum(np.abs(Bn), 1e-300)
                     / np.maximum(np.abs(Cn), 1e-300))
        Bn, Cn = Bn / al, Cn * al
        m = np.arange(K + 1)
        An_pows = np.zeros((K + 1, 2, 2))
        An_pows[:, 0, 0] = p1 ** m
        An_pows[:, 1, 1] = p2 ** m
        return An_pows, Bn, Cn
    return P.copy(), k.copy(), C             # defective: companion form


def stage_normal_form(b_row: np.ndarray, a_row: np.ndarray):
    """(A, B, C, D) of ONE biquad stage in the same balanced normal-form
    realization `BiquadChunked` uses (float64) — the single source of
    truth for state coordinates, so composite operators built from
    these stages (`compose_cascade_ops`) stay state-interchangeable
    with BiquadChunked."""
    b0, b1, b2 = np.asarray(b_row, np.float64)
    a1, a2 = float(a_row[1]), float(a_row[2])
    k = np.array([b1 - a1 * b0, b2 - a2 * b0])
    A = np.array([[-a1, 1.0], [-a2, 0.0]])
    P = np.stack([np.eye(2), A])
    pw, Bn, Cn = _normal_form_powers(a1, a2, k, 1, P)
    return pw[1], Bn, Cn, b0


def compose_cascade_ops(b: np.ndarray, a: np.ndarray, K: int):
    """Compose an S-stage df2T biquad cascade into ONE 2S-state linear
    system and precompute its K-sample chunk operators (float64):

        y_chunk  = x @ L.T + s @ R.T        L: (K,K)  R: (K,2S)
        s_next   = s @ AK.T + x @ G         G: (K,2S) AK: (2S,2S)

    The composite state vector is the CONCATENATION of the per-stage
    normal-form states (`stage_normal_form`), so it is interchangeable
    with `BiquadChunked` state laid out (..., S, 2).reshape(..., 2S)."""
    b = np.atleast_2d(np.asarray(b, np.float64))
    a = np.atleast_2d(np.asarray(a, np.float64))
    S = b.shape[0]
    A_c = np.zeros((0, 0))
    B_c = np.zeros((0,))
    C_c = np.zeros((0,))
    D_c = 1.0
    for s in range(S):
        # balanced normal-form stages: the df2T companion form's chunk
        # powers are ill-conditioned for near-unity poles (see
        # BiquadChunked)
        As, Bs, Cs, Ds = stage_normal_form(b[s], a[s])
        m = A_c.shape[0]
        A_new = np.zeros((m + 2, m + 2))
        A_new[:m, :m] = A_c
        A_new[m:, :m] = np.outer(Bs, C_c)
        A_new[m:, m:] = As
        A_c = A_new
        B_c = np.concatenate([B_c, Bs * D_c])
        C_c = np.concatenate([Ds * C_c, Cs])
        D_c = Ds * D_c
    S2 = 2 * S
    P = np.empty((K + 1, S2, S2))
    P[0] = np.eye(S2)
    for m in range(K):
        P[m + 1] = A_c @ P[m]
    h = np.empty(K)
    h[0] = D_c
    for n in range(1, K):
        h[n] = C_c @ P[n - 1] @ B_c
    L = np.zeros((K, K))
    for n in range(K):
        L[n, : n + 1] = h[: n + 1][::-1]
    R = np.einsum("d,ndk->nk", C_c, P[:K])           # (K, S2)
    G = np.stack([P[K - 1 - j] @ B_c for j in range(K)])  # (K, S2)
    return L, R, G, P[K]


class BiquadChunked:
    """Chunk-parallel streaming biquad cascade — exact df2T semantics with
    the per-sample dependency collapsed to one matmul per chunk.

    The df2T recurrence is the linear state-space system
        s[n+1] = A s[n] + k x[n],   y[n] = b0 x[n] + s1[n]
    with constant A = [[-a1, 1], [-a2, 0]], k = [b1 - a1*b0, b2 - a2*b0].
    Over a chunk of K samples this unrolls in closed form:
        y      = b0*x + s0 @ R.T + x @ L.T          (R: (K,2), L: (K,K))
        s_next = s0 @ (A^K).T + x @ G               (G: (K,2))
    with R[n] = (A^n)[0,:],  L[n,j] = (A^(n-1-j) k)[0] for j<n,
    G[j] = A^(K-1-j) k — all precomputed in float64 at design time.

    This turns the reference's per-sample CMSIS biquads
    (`arm_biquad_cascade_df2T_f32`, e.g. the RF-rate DC block
    `Process.cpp:127`) from an N-step serial scan into N/K matmuls:
    the 2048-sample RF block goes from 2048 sequential steps to 16.

    NUMERICS (round-5 fix): the operators are built in a BALANCED
    NORMAL-FORM realization, not the df2T companion form.  For a
    near-unity complex pole pair (the DC blocker: |p| = 0.99977,
    angle 2.3e-4 rad) the companion-form A^K has entries of ~±125 and
    an ill-conditioned eigenproblem — rounding it to f32 moved its
    eigenvalues from 0.9708 to {0.9995, 0.942}, making DC convergence
    ~40x too slow and leaving a display-visible DC spur that grew for
    a hundred blocks (caught by `bench.py --check` on the device).
    In the rotation form A = r·[[cos t, sin t], [-sin t, cos t]] the
    chunk power A^K = r^K·rot(K·t) is computed in closed form and its
    f32 rounding perturbs eigenvalues by ~1e-7, so the operator decays
    exactly like the per-sample recursion.  The carried state is in the
    realization's own coordinates (NOT df2T s1/s2 — input/output
    behavior is identical to f32 rounding, internal layout is not).
    """

    def __init__(self, b: np.ndarray, a: np.ndarray, chunk: int = 128):
        b = np.atleast_2d(np.asarray(b, np.float64))
        a = np.atleast_2d(np.asarray(a, np.float64))
        self.stages = b.shape[0]
        self.chunk = K = int(chunk)
        self.b0 = b[:, 0].astype(np.float32)
        Rs, Ls, AKs, Gs = [], [], [], []
        for s in range(self.stages):
            a1, a2 = a[s, 1], a[s, 2]
            b0, b1, b2 = b[s]
            A = np.array([[-a1, 1.0], [-a2, 0.0]])
            k = np.array([b1 - a1 * b0, b2 - a2 * b0])
            # companion-form powers: L (the in-chunk impulse-response
            # Toeplitz) is realization-independent and its h values are
            # small, so the companion form is fine for it
            P = np.empty((K + 1, 2, 2))
            P[0] = np.eye(2)
            for m in range(K):
                P[m + 1] = A @ P[m]
            Ak = P[:K] @ k                      # (K, 2): A^m k
            L = np.zeros((K, K))
            for n in range(1, K):
                # L[n, j] = (A^(n-1-j) k)[0], j = 0..n-1
                L[n, :n] = Ak[: n][::-1, 0]

            # balanced normal-form realization for the state recursion
            An_pows, Bn, Cn = _normal_form_powers(a1, a2, k, K, P)
            R = np.einsum("j,njk->nk", Cn, An_pows[:K])   # R[n] = Cn A^n
            G = np.einsum("njk,k->nj", An_pows[K - 1::-1], Bn)
            Rs.append(R)
            Ls.append(L)
            AKs.append(An_pows[K])
            Gs.append(G)
        self.R = np.stack(Rs).astype(np.float32)    # (S, K, 2)
        self.L = np.stack(Ls).astype(np.float32)    # (S, K, K)
        self.AK = np.stack(AKs).astype(np.float32)  # (S, 2, 2)
        self.G = np.stack(Gs).astype(np.float32)    # (S, K, 2)

    def apply(self, state: jnp.ndarray, x: jnp.ndarray):
        """state: (..., S, 2) df2T state;  x: (..., N), N % chunk == 0.
        Returns (new_state, y)."""
        K = self.chunk
        N = x.shape[-1]
        assert N % K == 0, (N, K)
        n_chunks = N // K
        lead = x.shape[:-1]
        new_states = []
        for s in range(self.stages):
            xs = jnp.moveaxis(x.reshape(lead + (n_chunks, K)), -2, 0)
            R = jnp.asarray(self.R[s])
            L = jnp.asarray(self.L[s])
            AK = jnp.asarray(self.AK[s])
            G = jnp.asarray(self.G[s])
            b0 = self.b0[s]

            def chunk_step(s0, xc, R=R, L=L, AK=AK, G=G, b0=b0):
                y = b0 * xc + s0 @ R.T + xc @ L.T
                s_next = s0 @ AK.T + xc @ G
                return s_next, y

            s_f, ys = jax.lax.scan(chunk_step, state[..., s, :], xs)
            x = jnp.moveaxis(ys, 0, -2).reshape(lead + (N,))
            new_states.append(s_f)
        new_state = jnp.stack(new_states, axis=-2)
        return new_state, x


def biquad_reference(x: np.ndarray, b: np.ndarray, a: np.ndarray) -> np.ndarray:
    """NumPy oracle: cascade of df2T biquads, zero initial state."""
    b = np.atleast_2d(b)
    a = np.atleast_2d(a)
    y = np.asarray(x, np.float64).copy()
    for s in range(b.shape[0]):
        out = np.empty_like(y)
        s1 = s2 = 0.0
        for n, v in enumerate(y):
            o = b[s, 0] * v + s1
            s1 = b[s, 1] * v - a[s, 1] * o + s2
            s2 = b[s, 2] * v - a[s, 2] * o
            out[n] = o
        y = out
    return y


def one_pole_dc_block(state, x, pole: float = 0.99):
    """The AM demod's one-pole DC-removal recurrence (reference
    `Process.cpp:700-704`):  w = x + pole*w_old;  y = w - w_old.

    state: (...,) w_old;  x: (..., N).  Returns (new_state, y).
    """
    def step(w_old, xn):
        w = xn + pole * w_old
        return w, w - w_old

    w, y = jax.lax.scan(step, state, jnp.moveaxis(x, -1, 0))
    return w, jnp.moveaxis(y, 0, -1)
