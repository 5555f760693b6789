"""The state-space dual (Mamba-2's SSD) over x (B, L, H, P), a (B, L, H)
and b, c (B, L, S) shared by a sequence's heads: each read once and y (B,
L, H, P) written once; its linear-time operations, whatever the chunk:
per token and head the state update h = a h + b x^T (3 S P) and the output
y = h^T c (2 S P)."""
from portbench.work.peaks import least_s


def work(B: int, L: int, H: int, P: int, S: int, itemsize: int = 4):
    """(bytes, flops) of one call."""
    nbytes = itemsize * (2 * B * L * H * P + B * L * H + 2 * B * L * S)
    return nbytes, 5.0 * B * L * H * S * P


def least(B: int, L: int, H: int, P: int, S: int, itemsize: int = 4
          ) -> float:
    return least_s(*work(B, L, H, P, S, itemsize))
