"""Built-in PASTA tool collection + string-keyed registry.

Tools register themselves with the :func:`~repro_torch.core.tools.base.register`
decorator and are selected by spec string — ``pasta.Session(tools=
"kernel_freq,timeline")``, knobs via ``"hotness:n_tbins=8,hot_frac=0.75"``,
or the ``PASTA_TOOL`` environment variable (the paper's CLI interface).
"""

from __future__ import annotations

import warnings

from .base import (PastaTool, TOOL_REGISTRY, register, parse_tool_spec,
                   resolve_tools)
from .kernel_freq import KernelFrequencyTool
from .workingset import WorkingSetTool
from .hotness import HotnessTool
from .timeline import MemoryTimelineTool
from .locator import LocatorTool
from .roofline import RooflineTool
from .serving import ServingTool
from . import offload
from . import roofline

#: compatibility alias — the registry is populated by @register decorators
REGISTRY = TOOL_REGISTRY


def make_tools(names: str | list | None = None, **kw) -> list:
    """Deprecated: instantiate tools by name (old hardcoded-table surface).
    Use ``pasta.Session(tools=...)`` or :func:`resolve_tools` instead."""
    warnings.warn(
        "pasta.make_tools() is deprecated; pass a tool spec to "
        "pasta.Session(tools=...) or use "
        "repro_torch.core.tools.resolve_tools()",
        DeprecationWarning, stacklevel=2)
    return resolve_tools(names, overrides=kw)


__all__ = ["PastaTool", "KernelFrequencyTool", "WorkingSetTool",
           "HotnessTool", "MemoryTimelineTool", "LocatorTool",
           "RooflineTool", "ServingTool", "offload", "roofline",
           "TOOL_REGISTRY", "REGISTRY", "register", "parse_tool_spec",
           "resolve_tools", "make_tools"]
