"""aa_snake_roofline.bulk: % of the anti-aliased SnakeBeta kernel's roofline bound reached in the traced sub-window (readers.roofline)."""

from port_bench.readers import roofline


def read(view):
    return roofline(view, "aa_snake")
