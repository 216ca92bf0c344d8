"""Number formatting replicating the reference binaries' TSV printers.

Pinned against the golden outputs in example/output/:

- ANI measures (tani/gani/ani/qcov/rcov) and pident: 6 significant digits,
  C ``%g`` style (``0.00525006``, ``0.970072``, ``39``, ``1``).
- len_ratio: fixed 4 decimals with trailing zeros kept (``0.6400``,
  ``0.9020``), except an exact ratio of 1 prints as ``1``.
- fltr.txt ani-shorter values: fixed 6 decimals (``0.998480``).
"""


def fmt_measure(v: float) -> str:
    """6-significant-digit %g formatting used for ANI measures and pident."""
    return f'{v:.6g}'


def fmt_len_ratio(v: float) -> str:
    return '1' if v == 1 else f'{v:.4f}'


def fmt_fltr_value(v: float) -> str:
    return f'{v:.6f}'
