"""Built-in PASTA tool collection + string-keyed registry.

Tools register themselves with the :func:`~repro_torch.core.tools.base.register`
decorator and are selected by spec string — ``pasta.Session(tools=
"kernel_freq,timeline")``, knobs via ``"hotness:n_tbins=8,hot_frac=0.75"``,
or the ``PASTA_TOOL`` environment variable (the paper's CLI interface).
"""

from __future__ import annotations

from .base import (PastaTool, TOOL_REGISTRY, register, parse_tool_spec,
                   resolve_tools)
from .kernel_freq import KernelFrequencyTool
from .workingset import WorkingSetTool
from .hotness import HotnessTool
from .timeline import MemoryTimelineTool
from .locator import LocatorTool
from .roofline import RooflineTool
from . import offload

__all__ = ["PastaTool", "KernelFrequencyTool", "WorkingSetTool",
           "HotnessTool", "MemoryTimelineTool", "LocatorTool",
           "RooflineTool", "offload",
           "TOOL_REGISTRY", "register", "parse_tool_spec", "resolve_tools"]
