"""The PyTorch port's grouped moment stage against the JAX engine's.

On CPU tensors ``grouped_moments_blocks`` runs its plain torch version; it
must match the JAX engine's Pallas digit-moment kernel (interpret mode, as
tests/test_ozaki.py runs it), its XLA digit form and its f64 einsum form.
Tolerances are the JAX suite's own: rtol 5e-13 / atol 1e-13 * max|M| for
the digit forms (tests/test_ozaki.py:39,100, truncation at ~2^-58), rtol
1e-13 for the f64 einsum (same products, another summation order; the
atol 1e-13 * max|M| covers entries that cancel to near zero). Counts are
integers and must match exactly. The CUDA kernel itself is checked
against the plain version on the card by tests/test_torch_gpu.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from polars_ols_tpu import CONFIG as JCONFIG  # noqa: E402
from polars_ols_tpu.ops import direct as jdirect  # noqa: E402
from polars_ols_tpu.ops.ozaki import decompose_blocks, moments_from_digits  # noqa: E402
from polars_ols_tpu.ops.pallas_moments import moments_from_digits_pallas  # noqa: E402

from polars_ols_tpu_torch import CONFIG  # noqa: E402
from polars_ols_tpu_torch.ops import direct, kernels, moments  # noqa: E402


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")


def _blocks(seed: int, n_groups: int, R: int, C: int):
    """Contiguous blocks (1-3 per group), column scales spread over
    decades, ~15% masked rows."""
    rng = np.random.default_rng(seed)
    n_blocks = rng.integers(1, 4, size=n_groups)
    S = int(n_blocks.sum())
    Zp = rng.normal(size=(S, R, C)) * np.exp(rng.normal(size=(1, 1, C)) * 3)
    wp = rng.random((S, R)) > 0.15
    block_group = np.repeat(np.arange(n_groups), n_blocks)
    offsets = np.concatenate([[0], np.cumsum(n_blocks)])
    return Zp, wp, block_group, offsets


def _port(Zp, wp, offsets, G):
    M, counts = moments.grouped_moments_blocks(
        torch.as_tensor(Zp), torch.as_tensor(wp), torch.as_tensor(offsets), G
    )
    return M.numpy(), counts.numpy()


SHAPES = [(5, 128, 5), (4, 37, 9), (3, 64, 1)]  # (G, R, C)


@pytest.mark.parametrize("G,R,C", SHAPES)
def test_plain_moments_match_pallas_interpret(G, R, C, monkeypatch):
    monkeypatch.setattr(JCONFIG, "interpret_pallas", True)
    Zp, wp, bg, offsets = _blocks(0, G, R, C)
    Zcat, m = decompose_blocks(jnp.asarray(Zp), jnp.asarray(wp))
    M_j, c_j = moments_from_digits_pallas(Zcat, m, jnp.asarray(wp), jnp.asarray(bg), G)
    M_t, c_t = _port(Zp, wp, offsets, G)
    M_j = np.asarray(M_j)
    np.testing.assert_allclose(M_t, M_j, rtol=5e-13, atol=1e-13 * np.abs(M_j).max())
    np.testing.assert_array_equal(c_t, np.asarray(c_j))


@pytest.mark.parametrize("G,R,C", SHAPES)
def test_plain_moments_match_ozaki(G, R, C):
    Zp, wp, bg, offsets = _blocks(1, G, R, C)
    Zcat, m = decompose_blocks(jnp.asarray(Zp), jnp.asarray(wp))
    M_j, c_j = moments_from_digits(Zcat, m, jnp.asarray(wp), jnp.asarray(bg), G)
    M_t, c_t = _port(Zp, wp, offsets, G)
    M_j = np.asarray(M_j)
    np.testing.assert_allclose(M_t, M_j, rtol=5e-13, atol=1e-13 * np.abs(M_j).max())
    np.testing.assert_array_equal(c_t, np.asarray(c_j))


# beside the main path's C = 6: the CUDA kernel's hand-overs (C = 8 | 9,
# 13 | 14) and mask bytes that are not 16-aligned (R = 37, R = 513)
@pytest.mark.parametrize(
    "G,R,C",
    [(6, 128, 6), (4, 37, 33), (2, 16, 2), (3, 64, 8), (3, 64, 9), (3, 40, 13), (3, 40, 14),
     (2, 513, 6)],
)
def test_direct_grouped_moments_match_jax_einsum(G, R, C):
    Zp, wp, bg, offsets = _blocks(2, G, R, C)
    XtX_j, Xty_j, c_j = jdirect.grouped_moments(
        jnp.asarray(Zp[..., 1:]), jnp.asarray(Zp[..., 0]), jnp.asarray(wp),
        jnp.asarray(bg), G,
    )
    XtX_t, Xty_t, c_t = direct.grouped_moments(
        torch.as_tensor(Zp), torch.as_tensor(wp), torch.as_tensor(offsets), G
    )
    for t, j in ((XtX_t, XtX_j), (Xty_t, Xty_j)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-13, atol=1e-13 * np.abs(j).max())
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))


def test_groups_without_blocks_get_zero_moments():
    """Groups without blocks, first, inside and last, against the JAX
    engine's segment sums."""
    n_blocks = np.asarray([0, 3, 0, 0, 2, 0])
    G, S, R, C = len(n_blocks), int(n_blocks.sum()), 48, 6
    rng = np.random.default_rng(5)
    Zp = rng.normal(size=(S, R, C))
    wp = rng.random((S, R)) > 0.15
    bg = np.repeat(np.arange(G), n_blocks)
    offsets = np.concatenate([[0], np.cumsum(n_blocks)])
    XtX_j, Xty_j, c_j = jdirect.grouped_moments(
        jnp.asarray(Zp[..., 1:]), jnp.asarray(Zp[..., 0]), jnp.asarray(wp), jnp.asarray(bg), G,
    )
    M_t, c_t = _port(Zp, wp, offsets, G)
    np.testing.assert_allclose(M_t[:, 1:, 1:], np.asarray(XtX_j), rtol=1e-13, atol=1e-12)
    np.testing.assert_allclose(M_t[:, 1:, 0], np.asarray(Xty_j), rtol=1e-13, atol=1e-12)
    np.testing.assert_array_equal(c_t, np.asarray(c_j))
    empty = n_blocks == 0
    assert (M_t[empty] == 0).all() and (c_t[empty] == 0).all()


def test_cpu_tensors_launch_no_kernel(monkeypatch):
    monkeypatch.setattr(moments, "moments_kernel_launches", 0)
    Zp, wp, _, offsets = _blocks(3, 4, 32, 4)
    _port(Zp, wp, offsets, 4)
    assert moments.moments_kernel_launches == 0


def _bad_inputs(case: str):
    Zp, wp, _, offsets = _blocks(4, 3, 16, 4)
    Zp, wp, offsets = torch.as_tensor(Zp), torch.as_tensor(wp), torch.as_tensor(offsets)
    G = 3
    if case == "f32":
        Zp = Zp.float()
    elif case == "non_contiguous":
        Zp = Zp.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "mask_dtype":
        wp = wp.to(torch.uint8)
    elif case == "offsets_shape":
        offsets = offsets[:-1]
    elif case == "offsets_dtype":
        offsets = offsets.to(torch.int32)
    elif case == "too_wide":  # past the wide form's 32-bit entry indices
        Zp = torch.zeros((Zp.shape[0], 1, moments.MAX_COLS + 1), dtype=torch.float64)
        wp = wp[:, :1].contiguous()
    return Zp, wp, offsets, G


@pytest.mark.parametrize(
    "case",
    ["f32", "non_contiguous", "mask_dtype", "offsets_shape", "offsets_dtype", "too_wide"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    with pytest.raises((TypeError, ValueError)):
        moments.grouped_moments_blocks(*_bad_inputs(case))


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if kernels.os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has the CUDA toolkit at /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build("moments")


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_nvcc", lambda: "/bin/false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernels.build("moments")
    assert not list(tmp_path.iterdir())
