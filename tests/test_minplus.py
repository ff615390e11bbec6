"""ops/minplus.py: the implementation choice, and the Triton-route kernel
(Pallas interpreter here; compiled on the card) against the jnp relax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from safepy_tpu.ops import minplus


def _rand(rng, shape, lo=0.0, hi=5.0, inf_frac=0.2):
    x = rng.uniform(lo, hi, size=shape).astype(np.float32)
    x[rng.random(shape) < inf_frac] = np.inf
    return jnp.asarray(x)


# --------------------------------------------------------------- the choice

def test_resolve_platforms():
    assert minplus.resolve(platform="cpu") == "jnp"
    assert minplus.resolve(platform="gpu") == "triton"


@pytest.mark.parametrize("platform", ["neuron", "METAL", "rocm"])
def test_resolve_unknown_platform_raises(platform):
    with pytest.raises(RuntimeError, match="no min-plus implementation"):
        minplus.resolve(platform=platform)


def test_resolve_explicit_impl_wins_and_is_checked():
    for impl in minplus.IMPLS:
        assert minplus.resolve(impl, platform="rocm") == impl
    with pytest.raises(ValueError, match="unknown min-plus impl"):
        minplus.resolve("pallas")


def test_interpret_only_on_request():
    """With no argument the CPU gets the jnp relax — never the interpreter —
    and so does a program placed on the CPU through jax.default_device."""
    assert minplus.resolve() == "jnp"
    with jax.default_device(jax.devices("cpu")[0]):
        assert minplus.resolve() == "jnp"
    with jax.default_device("gpu"):
        assert minplus.resolve() == "triton"


def test_facade_threads_the_impl(monkeypatch):
    """SAFE.minplus_impl reaches the FW engines; None means the platform's."""
    from safepy_tpu import pipeline
    from safepy_tpu.ops import apsp_banded

    seen = []
    real = minplus.resolve

    def spy(impl=None, platform=None):
        seen.append(impl)
        return real(impl, platform)

    monkeypatch.setattr(minplus, "resolve", spy)
    jax.clear_caches()
    d0 = jnp.where(jnp.eye(8, dtype=bool), 0.0, jnp.inf).astype(jnp.float32)
    rank = jnp.arange(8, dtype=jnp.int32)
    apsp_banded.apsp_banded_unpermuted(d0, rank, 1.0, window=128,
                                       impl="interpret")
    pipeline._apsp_inline(d0, 128, impl=None)
    assert "interpret" in seen and None in seen


# ---------------------------------------------------- kernel vs jnp relax

@pytest.mark.parametrize("m,n,k,tiles", [
    (128, 384, 128, minplus.TILES),
    (64, 192, 64, (64, 64, 4)),
    (32, 96, 32, (32, 32, 1)),
    (128, 256, 128, (64, 128, 4)),
])
def test_relax_kernel_bit_identical(rng, m, n, k, tiles):
    c = _rand(rng, (m, n), 1.0, 9.0)
    a = _rand(rng, (m, k))
    b = _rand(rng, (k, n))
    got = np.asarray(minplus.relax(c, a, b, impl="interpret", tiles=tiles))
    want = np.asarray(minplus.relax(c, a, b, impl="jnp"))
    np.testing.assert_array_equal(got, want)
    ref = np.minimum(np.asarray(c), np.min(np.asarray(a)[:, :, None]
                                           + np.asarray(b)[None], axis=1))
    np.testing.assert_array_equal(want, ref)


@pytest.mark.parametrize("chunk", [1, 3, 8, 128])
def test_relax_jnp_chunks_agree(rng, chunk):
    c = _rand(rng, (40, 24), 1.0, 9.0)
    a = _rand(rng, (40, 24))
    b = _rand(rng, (24, 24))
    got = np.asarray(minplus.relax_jnp(c, a, b, chunk=chunk))
    ref = np.minimum(np.asarray(c), np.min(np.asarray(a)[:, :, None]
                                           + np.asarray(b)[None], axis=1))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("w,block,band_tiles", [
    (256, 64, 4), (384, 64, 1), (192, 32, 2)])
def test_relax_upper_bit_identical(rng, w, block, band_tiles):
    d = np.asarray(_rand(rng, (w, w), 1.0, 9.0))
    d = jnp.asarray(np.minimum(d, d.T))
    q = _rand(rng, (w, block))
    p = jnp.asarray(np.asarray(q).T)
    got = minplus.relax_upper(d, q, p, block=block, band_tiles=band_tiles,
                              impl="interpret")
    want = minplus.relax_upper(d, q, p, block=block, band_tiles=band_tiles,
                               impl="jnp")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    # in band the result is the full relax (q == p.T); out of band, d
    full = np.asarray(minplus.relax_jnp(d, q, p))
    t = np.arange(w) // block
    in_band = np.abs(t[:, None] - t[None, :]) <= band_tiles
    np.testing.assert_array_equal(np.asarray(got)[in_band], full[in_band])
    np.testing.assert_array_equal(np.asarray(got)[~in_band],
                                  np.asarray(d)[~in_band])


@pytest.mark.parametrize("bt,block", [(1, 64), (2, 32), (3, 32)])
def test_relax_skew_bit_identical(rng, bt, block):
    nt = 2 * bt + 1
    win = _rand(rng, (nt * block, nt * block), 1.0, 9.0)
    p = _rand(rng, (block, nt * block))
    p_ext = jnp.pad(p, ((0, 0), (bt * block, bt * block)),
                    constant_values=np.inf)
    got = minplus.relax_skew(win, p_ext, bt=bt, block=block,
                             impl="interpret")
    want = minplus.relax_skew(win, p_ext, bt=bt, block=block, impl="jnp")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_close_tile_kernel_bit_identical(rng):
    t = np.asarray(_rand(rng, (64, 64), 0.1, 9.0, inf_frac=0.6))
    t = np.minimum(t, t.T)
    np.fill_diagonal(t, 0.0)
    got = np.asarray(minplus.close_tile(jnp.asarray(t), impl="interpret"))
    want = np.asarray(minplus.close_tile(jnp.asarray(t), impl="jnp"))
    np.testing.assert_array_equal(got, want)
    ref = t.copy()
    for k in range(64):
        ref = np.minimum(ref, ref[:, k:k + 1] + ref[k:k + 1, :])
    np.testing.assert_array_equal(want, ref)


def test_kernel_tiles_must_divide_the_block():
    with pytest.raises(ValueError, match="does not divide"):
        minplus._kernel_tiles(96, (64, 64, 8))
    assert minplus._kernel_tiles(32, (64, 64, 8)) == (32, 32, 8)


def test_kernels_lower_for_the_card(rng):
    """Every kernel lowers to Triton IR for CUDA, with x64 on (the lowering,
    not the GPU compile, runs without a card)."""
    w, block, bt = 256, 128, 1
    d = _rand(rng, (w, w))
    q = _rand(rng, (w, block))
    cases = [
        lambda: minplus.relax(d[:block], q[:block], d[:block],
                              impl="triton"),
        lambda: minplus.relax_upper(d, q, q.T, block=block, band_tiles=1,
                                    impl="triton"),
        lambda: minplus.relax_skew(
            jnp.zeros((3 * block, 3 * block), jnp.float32),
            jnp.zeros((block, 5 * block), jnp.float32), bt=bt, block=block,
            impl="triton"),
        lambda: minplus.close_tile(q[:block], impl="triton"),
    ]
    for case in cases:
        text = jax.jit(case).trace().lower(
            lowering_platforms=("cuda",)).as_text()
        assert "triton" in text.lower()


@pytest.mark.gpu
def test_triton_kernels_on_card(gpu, rng):
    """Compiled for the card: every kernel gives the jnp relax's bits."""
    w, block, bt = 512, 128, 1
    d = np.asarray(_rand(rng, (w, w), 1.0, 9.0))
    d = jnp.asarray(np.minimum(d, d.T))
    q = _rand(rng, (w, block))
    for impl_fn in (
            lambda impl: minplus.relax(d[:block], q[:block], d[:block],
                                       impl=impl),
            lambda impl: minplus.relax_upper(d, q, q.T, block=block,
                                             band_tiles=2, impl=impl),
            lambda impl: minplus.relax_skew(
                d[:3 * block, :3 * block],
                jnp.pad(d[:block, :3 * block],
                        ((0, 0), (block, block)), constant_values=np.inf),
                bt=bt, block=block, impl=impl),
            lambda impl: minplus.close_tile(d[:block, :block], impl=impl)):
        np.testing.assert_array_equal(np.asarray(impl_fn("triton")),
                                      np.asarray(impl_fn("jnp")))
