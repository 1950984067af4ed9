"""PASTA core on PyTorch — the paper's contribution as a composable module.

Public surface (``import repro_torch.core as pasta``):

  * session:     ``pasta.Session`` — the unified facade: scoped attachment,
                 tool registry, structured ``Report``s (paper §III's
                 "unified interface to capture and analyze runtime events")
  * annotations: ``pasta.start / pasta.end / pasta.region`` (paper Listing 1)
                 — route to the innermost active session
  * modules:     EventHandler → EventProcessor → tool collection (owned by a
                 Session; still composable by hand)
  * memory:      MemoryPool (caching-allocator model)
  * artifacts:   capture (profiled-step capture, the counterpart of the
                 reference's HLO walker), tools.roofline
"""

from .annotate import start, end, region, GridIdFilter, current_region
from .events import Event, EventBatch, EventKind, EventRing, take_seqs
from .handler import EventHandler
from .pool import MemoryPool, MemoryObject, TensorHandle, CHUNK_ALIGN
from .processor import (EventProcessor, analyze_access_trace,
                        analyze_hotness_trace, analyze_trace_fused)
from .session import (Session, Report, Reports, active_session,
                      current_session, current_handler, root_session)
from . import capture
from . import tools
from .tools import (PastaTool, KernelFrequencyTool, WorkingSetTool,
                    HotnessTool, MemoryTimelineTool, LocatorTool,
                    TOOL_REGISTRY, register, parse_tool_spec, resolve_tools)
from .tools import offload

__all__ = [
    "Session", "Report", "Reports", "active_session", "current_session",
    "current_handler", "root_session",
    "start", "end", "region", "GridIdFilter", "current_region",
    "Event", "EventBatch", "EventKind", "EventRing", "take_seqs",
    "EventHandler", "MemoryPool", "MemoryObject", "TensorHandle",
    "CHUNK_ALIGN", "EventProcessor", "analyze_access_trace",
    "analyze_hotness_trace", "analyze_trace_fused", "capture", "tools",
    "PastaTool",
    "KernelFrequencyTool", "WorkingSetTool", "HotnessTool",
    "MemoryTimelineTool", "LocatorTool", "TOOL_REGISTRY",
    "register", "parse_tool_spec", "resolve_tools", "offload",
]
