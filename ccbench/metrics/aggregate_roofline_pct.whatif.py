"""``aggregate_roofline_pct`` in the what-if cells: the aggregate kernel's
least time a call at the cell's shape over its mean device time a launch."""

from ccbench.harness.roofline import kernel_roofline_pct


def read(run):
    return kernel_roofline_pct(run)
