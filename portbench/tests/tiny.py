"""Cells of the manifest cut to a size a CPU test run holds."""

from portbench import harness

TINY = {"grouped_k5": dict(rows=3_000, groups=12), "grouped_largek": dict(rows=1_200, groups=3)}
CELLS = ("grouped_k5.ols", "grouped_largek.moving", "grouped_largek.svd", "grouped_k5.sweep")


def tiny_cell(name: str) -> harness.Cell:
    cell = harness.Cell.load(name)
    cell.cfg.update(TINY[cell.cfg["name"]])
    return cell
