"""The probe kernel's wrapper on the CPU against the JAX probe it ports.

``experiments/pallas_grid_probe.py``'s ``copy_kernel`` runs through
``pl.pallas_call(..., interpret=True)`` with the JAX probe's own grid and
``BlockSpec``; ``grid_probe.scale_copy`` takes the same numpy-made f32
input on the CPU, where it runs its plain version. Doubling an f32 is
exact in both, so the outputs are held bit for bit. The kernel itself runs
only on the card (``tests/test_torch_gpu.py``).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from polars_ols_tpu_torch.ops import grid_probe  # noqa: E402

JAX_PROBE = Path(__file__).resolve().parents[1] / "experiments" / "pallas_grid_probe.py"


def _copy_kernel():
    """The JAX probe's kernel body, loaded from its file (it is a script,
    not a package module)."""
    spec = importlib.util.spec_from_file_location("pallas_grid_probe", JAX_PROBE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.copy_kernel


def _pallas_probe(x: np.ndarray, block_rows):
    """The JAX probe's calls in interpret mode: ungridded over the whole
    array, or gridded over row tiles of ``block_rows``."""
    rows, cols = x.shape
    out_shape = jax.ShapeDtypeStruct((rows, cols), jnp.float32)
    if block_rows is None:
        call = pl.pallas_call(_copy_kernel(), out_shape=out_shape, interpret=True)
    else:
        spec = pl.BlockSpec((block_rows, cols), lambda i: (i, 0))
        call = pl.pallas_call(
            _copy_kernel(),
            grid=(rows // block_rows,),
            in_specs=[spec],
            out_specs=spec,
            out_shape=out_shape,
            interpret=True,
        )
    return np.asarray(call(jnp.asarray(x)))


def _input(values: str, rows: int, cols: int) -> np.ndarray:
    if values == "arange":  # the JAX probe's own input
        return np.arange(rows * cols, dtype=np.float32).reshape(rows, cols)
    rng = np.random.default_rng(rows * cols)
    scale = 10.0 ** rng.uniform(-30, 30, size=(rows, cols))
    return (rng.normal(size=(rows, cols)) * scale).astype(np.float32)


@pytest.mark.parametrize("values", ["arange", "normal"])
@pytest.mark.parametrize(
    "rows,cols,block_rows",
    [
        (256, 256, None),  # ungridded: the JAX probe's x[:256]
        (2048, 256, 256),  # gridded: grid=(8,), BlockSpec((256, 256))
        (300, 7, 100),  # ragged
    ],
)
def test_probe_matches_jax_probe_bit_for_bit(values, rows, cols, block_rows, monkeypatch):
    monkeypatch.setattr(grid_probe, "scale_copy_launches", 0)
    x = _input(values, rows, cols)
    want = _pallas_probe(x, block_rows)
    got = grid_probe.scale_copy(torch.from_numpy(x), block_rows)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    assert grid_probe.scale_copy_launches == 0


@pytest.mark.parametrize("block_rows", [None, 256])
def test_probe_plain_path_doubles_and_counts_no_launch(block_rows, monkeypatch):
    monkeypatch.setattr(grid_probe, "scale_copy_launches", 0)
    x = torch.arange(2048 * 256, dtype=torch.float32).reshape(2048, 256)
    out = grid_probe.scale_copy(x, block_rows)
    assert out.dtype == torch.float32
    assert torch.equal(out, x * 2.0)
    assert grid_probe.scale_copy_launches == 0


@pytest.mark.parametrize("case", ["f64", "one_dim", "non_contiguous", "ragged_tiles"])
def test_probe_wrapper_rejects_what_the_kernel_does_not_take(case):
    x = torch.zeros((512, 256), dtype=torch.float32)
    block_rows = None
    if case == "f64":
        x = x.double()
    elif case == "one_dim":
        x = x.reshape(-1)
    elif case == "non_contiguous":
        x = x.t()
    else:
        block_rows = 300
    with pytest.raises((TypeError, ValueError)):
        grid_probe.scale_copy(x, block_rows)


def test_empty_kernel_needs_a_cuda_device():
    with pytest.raises(ValueError, match="CUDA device"):
        grid_probe.empty_launch(torch.device("cpu"))
