from .logging import create_logger, get_logger  # noqa: F401
from .fmt import fmt_measure, fmt_len_ratio, fmt_fltr_value  # noqa: F401
