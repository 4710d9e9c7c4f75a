"""The port's own C++ host helpers, and what the port imports.

The port compiles its own copy of the helpers,
``polars_ols_tpu_torch/engine/native/factorize.cpp``, never a file of the
JAX package. Every map the helpers build is an integer array, so the
port's must equal the JAX package's exactly. No module of the port, and
not ``chip_smoke.py`` or ``chip_ab_jacobi.py``, imports jax or the JAX
package or builds a path into it.
"""

import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from polars_ols_tpu.engine import native as jnative  # noqa: E402

from polars_ols_tpu_torch.engine import native as tnative  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "polars_ols_tpu_torch"
PORT_FILES = sorted(p.relative_to(REPO).as_posix() for p in PORT.rglob("*.py")) + ["chip_smoke.py", "chip_ab_jacobi.py"]


def test_source_is_the_ports_own_copy():
    src = tnative.SOURCE
    assert src.is_file()
    assert PORT in src.parents
    assert REPO / "polars_ols_tpu" not in src.parents


def test_the_copy_defines_every_function_the_bindings_load():
    text = tnative.SOURCE.read_text()
    for name in ("pols_factorize_i64", "pols_layout_build", "pols_scatter_blocks", "pols_unpad_map"):
        assert f"{name}(" in text, name


def test_the_helpers_build_from_the_copy(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_TRIED", False)
    assert tnative.native_loaded()
    assert len(list(tmp_path.glob("libpols_native_*.so"))) == 1


@pytest.mark.parametrize(
    "n,n_groups,r_cap,seed",
    [(2_000, 17, 64, 0), (5_000, 300, 16, 1), (100, 1, 512, 2), (3_000, 1_000, 8, 3)],
)
def test_the_maps_equal_the_jax_packages(n, n_groups, r_cap, seed):
    if not tnative.native_loaded() or jnative._load() is None:
        pytest.skip("needs g++ to build both packages' helpers")
    rng = np.random.default_rng(seed)
    keys = rng.integers(-(10**12), 10**12, size=n_groups)[rng.integers(n_groups, size=n)]
    gids = tnative.native_factorize(keys)
    np.testing.assert_array_equal(gids, jnative.native_factorize(keys))
    G = int(gids.max()) + 1
    layout = tnative.native_layout_build(gids, G)
    for mine, theirs in zip(layout, jnative.native_layout_build(gids, G)):
        np.testing.assert_array_equal(mine, theirs)
    counts, _, rank = layout
    n_blocks = np.maximum(1, -(-counts // r_cap))
    block_first = np.zeros(G, dtype=np.int64)
    np.cumsum(n_blocks[:-1], out=block_first[1:])
    S = int(n_blocks.sum())
    for mine, theirs in zip(
        tnative.native_scatter_blocks(gids, rank, block_first, r_cap, S),
        jnative.native_scatter_blocks(gids, rank, block_first, r_cap, S),
    ):
        np.testing.assert_array_equal(mine, theirs)
    np.testing.assert_array_equal(
        tnative.native_unpad_map(gids, rank, block_first, r_cap),
        jnative.native_unpad_map(gids, rank, block_first, r_cap),
    )


def _imports_and_names(path: Path):
    """Modules a file imports (absolute imports) and its string constants."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (("import", a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield "import", node.module
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield "string", node.value


def test_the_check_covers_every_module_of_the_port():
    # among them the formula parser (a plain Python copy of the JAX
    # package's) and the wrappers of the Householder reduction and the
    # Jacobi SVD
    for rel in ("polars_ols_tpu_torch/utils.py", "polars_ols_tpu_torch/ops/householder.py",
                "polars_ols_tpu_torch/ops/jacobi.py"):
        assert rel in PORT_FILES


@pytest.mark.parametrize("rel", PORT_FILES)
def test_the_port_stands_without_the_jax_package(rel):
    for kind, name in _imports_and_names(REPO / rel):
        if kind == "import":
            assert name.split(".")[0] not in ("jax", "jaxlib", "polars_ols_tpu"), f"{rel} imports {name}"
        else:  # a path component that would reach into the JAX package
            assert name != "polars_ols_tpu", f"{rel} builds a path into the JAX package"
