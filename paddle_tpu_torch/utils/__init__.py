"""Process-level utilities of the port: flags (`flags`), packaging an
inference export into one file (`merge_model`), a Program as Graphviz
DOT or text (`model_diagram`), and torch weights into a Program's
parameters (`torch2paddle`)."""

from . import flags
from .flags import DEFINE_flag, get_flag, set_flag, parse_flags_from_env

__all__ = ["flags", "DEFINE_flag", "get_flag", "set_flag",
           "parse_flags_from_env"]
