"""AGC Triton kernel parity in the Pallas interpreter, the wrapper's
padding and the choice of kernel.  The compiled kernel runs on the card
through `chip_smoke.py` and the `gpu`-marked test below."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from t41x.dsp import agc as A


def _stream(p, st, x, blocks, kernel):
    ys = []
    for b in range(blocks):
        st, y = A.agc_apply(p, st, jnp.asarray(x[b]), kernel=kernel)
        ys.append(y)
    return st, ys


def _blocks(ch, n, blocks, seed):
    rng = np.random.default_rng(seed)
    # alternate loud and quiet blocks so attack, hang and decay all run
    scale = np.where(np.arange(blocks) % 2, 0.05, 1.0)[:, None, None]
    return ((rng.standard_normal((blocks, ch, n))
             + 1j * rng.standard_normal((blocks, ch, n))) * scale
            ).astype(np.complex64)


def _assert_agc_equal(st_p, y_p, st_s, y_s):
    np.testing.assert_allclose(np.asarray(y_p), np.asarray(y_s),
                               rtol=1e-6, atol=1e-7)
    for f in st_s._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(st_p, f)), np.asarray(getattr(st_s, f)),
            rtol=1e-6, atol=1e-7, err_msg=f)


def test_agc_block_pallas_matches_scan_path():
    """The Triton kernel (interpreted) vs the lax.scan path over several
    256-sample blocks with the state carried."""
    p = A.agc_params(2)
    ch, n = 5, 256
    x = _blocks(ch, n, 3, seed=7)
    st = jax.tree.map(jnp.asarray, A.agc_state(p, (ch,)))
    st_s, y_s = _stream(p, st, x, 3, None)
    st_p, y_p = _stream(p, st, x, 3, "interpret")
    _assert_agc_equal(st_p, y_p[-1], st_s, y_s[-1])


def test_agc_scan_pallas_short_block_path():
    """Blocks shorter than the look-ahead (N < attack_buffsize) go
    through the same kernel."""
    p = A.agc_params(2)
    assert p.attack_buffsize > 64
    ch, n = 5, 64
    x = _blocks(ch, n, 4, seed=11)
    st = jax.tree.map(jnp.asarray, A.agc_state(p, (ch,)))
    st_s, y_s = _stream(p, st, x, 4, None)
    st_p, y_p = _stream(p, st, x, 4, "interpret")
    _assert_agc_equal(st_p, y_p[-1], st_s, y_s[-1])


@pytest.mark.parametrize("ch", [1, 127, 129, 1000, 1030])
def test_agc_kernel_pads_channels(ch):
    """Odd channel counts: the wrapper pads to a whole number of tiles
    (1030 = 128 tiles of 8 and 6 more) and trims, and every channel
    matches the scan."""
    p = A.agc_params(4)
    x = _blocks(ch, 32, 2, seed=ch)
    st = jax.tree.map(jnp.asarray, A.agc_state(p, (ch,)))
    st_s, y_s = _stream(p, st, x, 2, None)
    st_p, y_p = _stream(p, st, x, 2, "interpret")
    assert y_p[-1].shape == (ch, 32)
    _assert_agc_equal(st_p, y_p[-1], st_s, y_s[-1])


def test_agc_kernel_tiles_fill_the_card():
    """1024 channels spread over (nearly) all 132 SMs; tiles are powers
    of two and never exceed four warps."""
    from t41x.kernels.agc_triton import tile_channels

    for c, programs in ((1024, 128), (4096, 128), (1000, 125)):
        t = tile_channels(c)
        assert t & (t - 1) == 0 and -(-c // t) == programs, (c, t)
    assert tile_channels(1 << 20) == 128
    assert tile_channels(1) == 1


def test_agc_kernel_choice_follows_platform():
    """The GPU takes the compiled kernel; any other platform the plain
    scan; interpret mode is only ever asked for by name."""
    from t41x.chain import ChainSpec
    from t41x.kernels import agc_kernel_for
    from t41x.radio import Radio

    assert agc_kernel_for("gpu") == "triton"
    assert agc_kernel_for("cpu") is None
    assert jax.default_backend() == "cpu"
    assert Radio().chain.spec.agc_kernel is None
    with pytest.raises(ValueError, match="AGC kernel"):
        ChainSpec(agc_kernel="mosaic")
    p = A.agc_params(2)
    st = A.agc_state(p, (2,))
    with pytest.raises(ValueError, match="AGC kernel"):
        A.agc_apply(p, st, jnp.zeros((2, 256), jnp.complex64),
                    kernel="auto")


@pytest.mark.gpu
def test_agc_kernel_compiled_matches_scan(gpu_device):
    """On the card: the compiled kernel vs the scan at 1000 channels."""
    p = A.agc_params(2)
    ch = 1000
    x = _blocks(ch, 256, 4, seed=3)
    st = jax.tree.map(jnp.asarray, A.agc_state(p, (ch,)))
    st_s, y_s = _stream(p, st, x, 4, None)
    st_p, y_p = _stream(p, st, x, 4, "triton")
    for f in ("hang_counter", "decay_type", "state"):
        np.testing.assert_array_equal(np.asarray(getattr(st_p, f)),
                                      np.asarray(getattr(st_s, f)))
    np.testing.assert_allclose(np.asarray(y_p[-1]), np.asarray(y_s[-1]),
                               rtol=1e-5, atol=1e-6)
