"""The rest of ``repro.core``'s public surface on the port: the deprecated
shims over the implicit root session (``attach``, ``default_handler``,
``make_tools`` with ``REGISTRY``), ``COLLECTIVE_OPCODES`` and the tools
the reference exports at the ``core`` level.

The two shim tests are tests/test_session.py's (312-337) on
``repro_torch.core``, with their ``DeprecationWarning``s.  The surface
test holds ``repro_torch.core.__all__`` to cover ``repro.core.__all__``,
apart from ``hlo``: the reference's HLO walker has two counterparts on
the port, ``capture`` (a profiled call) and ``trace`` (a fake-tensor
step trace), settled in ROADMAP §3.
"""

import pytest

import repro.core as jpasta
import repro_torch.core as pasta
from repro_torch.core import capture as tcapture
from repro_torch.core import session as S
from repro_torch.core import trace as ttrace
from repro_torch.core.events import Event, EventKind, reset_seq

#: reference names with a differently named counterpart on the port
SETTLED = {"hlo": ("capture", "trace")}


@pytest.fixture(autouse=True)
def _port_state():
    reset_seq()
    S.reset_state()
    yield
    S.reset_state()


def test_deprecated_shims_still_work():
    with pytest.warns(DeprecationWarning, match="pasta.attach"):
        h = pasta.attach()
    assert h is S.root_session().handler
    with pytest.warns(DeprecationWarning, match="pasta.default_handler"):
        h2 = pasta.default_handler()
    assert h2 is h
    with pytest.warns(DeprecationWarning, match="pasta.make_tools"):
        tools = pasta.make_tools("kernel_freq,timeline")
    assert [type(t).__name__ for t in tools] == ["KernelFrequencyTool",
                                                 "MemoryTimelineTool"]
    # the shimmed wiring still functions end to end
    with pytest.warns(DeprecationWarning):
        handler = pasta.attach()
    proc = pasta.EventProcessor(handler, tools=tools)
    handler.emit(Event(EventKind.KERNEL_LAUNCH, name="x", attrs={"count": 3}))
    assert proc.finalize()["KernelFrequencyTool"]["total_invocations"] == 3
    proc.close()


def test_shim_attach_respects_innermost_session():
    """default_handler() inside a session scope resolves that session —
    legacy emit sites compose with scoped sessions."""
    with pasta.Session(name="scoped") as s:
        with pytest.warns(DeprecationWarning):
            assert pasta.default_handler() is s.handler


def test_core_all_covers_the_reference_surface():
    ours = set(pasta.__all__)
    for name in jpasta.__all__:
        wanted = SETTLED.get(name, (name,))
        assert set(wanted) <= ours, name
        for w in wanted:
            assert hasattr(pasta, w), w


def test_registry_alias_and_core_level_tools():
    assert pasta.tools.REGISTRY is pasta.TOOL_REGISTRY
    assert pasta.RooflineTool is pasta.tools.RooflineTool
    assert pasta.ServingTool is pasta.tools.ServingTool
    assert pasta.roofline.RooflineTool is pasta.RooflineTool
    assert {"roofline", "serving"} <= set(pasta.TOOL_REGISTRY)


def test_collective_opcodes_name_the_port_s_collective_events():
    assert pasta.COLLECTIVE_OPCODES == jpasta.COLLECTIVE_OPCODES
    named = {op for _frag, op in tcapture._NCCL_OPCODES}
    named |= set(ttrace._COLLECTIVES.values())
    assert named <= set(pasta.COLLECTIVE_OPCODES)
