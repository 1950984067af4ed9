"""The port's serve launcher (``python -m repro_torch.launch.serve``) on the
CPU: the reference launcher's ``--json`` contract, the flag it refuses and
the mesh flags it checks, the multi-tenant, chaos and replay paths, the
fleet ``kernel_freq`` report from one captured decode call, and the
launcher on four gloo ranks."""

import json
import os
import subprocess
import sys

import pytest

from repro_torch.core import events as tevents
from repro_torch.core import session as tsession
from repro_torch.launch import serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--arch", "paper-gpt2", "--reduced", "--num-requests", "4",
        "--max-slots", "2", "--prompt-len", "16", "--shared-prefix", "12",
        "--prefix-block", "8", "--max-new-tokens", "4"]


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "0")   # reference: jnp path
    tevents.reset_seq()
    tsession.reset_state()
    yield
    tsession.reset_state()


def _keys(d: dict, depth: int = 2) -> set:
    out = set()
    for k, v in d.items():
        out.add(k)
        if depth > 1 and isinstance(v, dict) and k in ("config", "summary"):
            out |= {f"{k}.{kk}" for kk in _keys(v, depth - 1)}
    return out


def test_cli_json_has_the_reference_launchers_keys(tmp_path, monkeypatch):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    path = tmp_path / "port.json"
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        *ARGS, "--device", "cpu", "--json", str(path)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    got = json.loads(path.read_text())

    from repro.launch import serve as jserve
    ref_path = tmp_path / "ref.json"
    monkeypatch.setattr(sys, "argv", ["serve", *ARGS, "--json",
                                      str(ref_path)])
    assert jserve.main() == 0
    want = json.loads(ref_path.read_text())

    assert _keys(got) - _keys(want) == {"config.device"}
    assert _keys(want) <= _keys(got)
    assert set(got["fleet"]) == set(want["fleet"]) == {"serving",
                                                       "kernel_freq"}
    assert got["status"] == "ok" and got["config"]["device"] == "cpu"
    s = got["summary"]
    assert s["generated_tokens"] == want["summary"]["generated_tokens"] == 16
    assert s["prefix_hit_rate"] > 0 and s["occupancy_mean"] > 1
    assert s["pool"]["duplicate_copy_bytes"] == 0
    assert len(got["requests"]) == 4
    assert got["fleet"]["kernel_freq"]["total_invocations"] > 0
    assert set(got["request_states"].values()) == {"finished"}


@pytest.mark.parametrize("flag", [
    pytest.param(["--devices", "2"], id="flag0"),
    pytest.param(["--mesh", "1x2"], id="flag1"),
    pytest.param(["--compile-cache", "cache"], id="flag2")])
def test_flags_without_a_counterpart_raise(flag):
    """``--compile-cache`` has no counterpart and raises.  ``--devices``
    and ``--mesh`` are parsed (serving on a mesh), and ``run`` refuses a
    mesh that does not cover the ranks: 1x1 for two devices, 1x2 for
    none."""
    if flag[0] == "--compile-cache":
        with pytest.raises(NotImplementedError):
            serve.parse_args(["--device", "cpu", *flag])
        return
    args = serve.parse_args(["--device", "cpu", *flag])
    assert (args.devices, args.mesh) == ((2, "1x1") if flag[0] == "--devices"
                                         else (0, "1x2"))
    with pytest.raises(ValueError, match="--mesh"):
        serve.run(args)


def test_cli_on_a_two_by_two_mesh_writes_rank_zeros_json(tmp_path):
    """Four gloo ranks on data 2 x model 2 serve the default trace: rank 0
    alone prints and writes the JSON, with the reference's keys and
    ``config.mesh`` as given, and its tokens are the same command's at
    world 1."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    common = [sys.executable, "-m", "repro_torch.launch.serve", "--device",
              "cpu", "--reduced"]
    one = tmp_path / "one.json"
    r = subprocess.run([*common, "--json", str(one)], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    mesh = tmp_path / "mesh.json"
    r = subprocess.run([*common, "--devices", "4", "--mesh", "2x2",
                        "--json", str(mesh)], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.count(f"[serve] wrote {mesh}") == 1
    assert r.stdout.count("[serve] 8 requests, 128 tokens") == 1
    got, want = json.loads(mesh.read_text()), json.loads(one.read_text())
    assert got["config"]["mesh"] == "2x2"
    assert _keys(got) - _keys(want) == {"mesh"}
    assert _keys(want) <= _keys(got)
    assert got["mesh"]["shape"] == [2, 2]
    assert not any(got["mesh"]["trace_kernel_launches"].values())
    assert got["tokens"] == want["tokens"]
    assert set(got["request_states"].values()) == {"finished"}


def test_traffic_priority_and_chaos_through_the_launcher(tmp_path):
    """The two-tenant trace under the priority policy with one poisoned
    request: it alone fails, every other request finishes, and the
    high-priority tenant preempts."""
    path = tmp_path / "chaos.json"
    assert serve.main(["--arch", "paper-gpt2", "--reduced", "--device",
                       "cpu", "--traffic", "two-tenant-bursty", "--policy",
                       "priority", "--max-slots", "2", "--chaos",
                       "one-poison", "--json", str(path)]) == 0
    out = json.loads(path.read_text())
    states = list(out["request_states"].values())
    assert states.count("failed") == 1
    assert states.count("finished") == len(states) - 1 == 7
    h = out["summary"]["engine_health"]
    assert h["failed"] == 1 and h["isolated_innocents"] > 0
    assert out["summary"]["faults"]["name"] == "one-poison"
    assert set(out["summary"]["tenants"]) == {"lo", "hi"}


def test_saved_trace_replays_to_the_same_tokens(tmp_path):
    """A trace saved by one run and replayed by another gives the same
    tokens at temperature 0.8: the sampler is keyed by (rid, position)."""
    trace = tmp_path / "trace.jsonl"
    common = ["--arch", "paper-gpt2", "--reduced", "--device", "cpu",
              "--temperature", "0.8", "--max-new-tokens", "6",
              "--num-requests", "5"]
    first = serve.run(serve.parse_args(common + ["--save-trace",
                                                 str(trace)]))["result"]
    again = serve.run(serve.parse_args(common + ["--trace-file",
                                                 str(trace)]))["result"]
    assert first["tokens"] == again["tokens"]
    assert again["config"]["trace_file"] == str(trace)
    assert sum(map(len, first["tokens"].values())) == 30
