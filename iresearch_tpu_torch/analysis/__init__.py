"""Text analysis: a copy of ``iresearch_tpu/analysis`` (reference:
core/analysis/).

Host-side token streams feeding the writer. Analyzers are registered by
name and configured from JSON, mirroring ``analyzers::get`` (reference:
core/analysis/analyzers.cpp, text_token_stream.cpp:944-971).
"""

from iresearch_tpu_torch.analysis.token import Token
from iresearch_tpu_torch.analysis.analyzers import Analyzer, get, register, registered
from iresearch_tpu_torch.analysis import numeric as _numeric  # registers "numeric"

__all__ = ["Token", "Analyzer", "get", "register", "registered"]
