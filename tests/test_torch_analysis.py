"""The port's static-analysis gate: analysis/astlint.py,
analysis/trace_audit.py and the CLI's `analyze` (counterparts of the JAX
package's analysis/ and cmd_analyze).

- Each rule fires on its golden violation (a fixture placed where the
  rule looks: models/, ops/, outside parallel/) and `analyze` exits 1 on
  it; each rule is silent on the port as it stands; a waiver needs the
  rule's id and carries its reason; a baseline written by
  --write-baseline absorbs what it counted; --json has the JAX report's
  keys; `analyze` exits 0 on the repo with no baseline file.
- The audits at audit_config sizes: 4 train variants with 4 distinct
  op-sequence signatures (scan_layers changes the optimizer's decay mask,
  as JAX's scanned tree does), 4 decode variants with 3 (both prompt
  lengths share the chunked prefill); no host sync outside the allow-list
  and a positive control that detect_host_syncs sees .item(), boolean
  masks and nonzero; sharding coverage 1.0; a crashing audit fails its
  verdict.
- The collective audits on an 8-rank fake mesh (dcn 2 x ici 4): the a2a
  dispatch's cross-node bytes below the replicated gather's, the
  hierarchical gradient sync's below the flat one's, their counts pinned.
"""

import json
import textwrap

import pytest
import torch

from luminaai_tpu import cli as jcli
from luminaai_tpu_torch import cli
from luminaai_tpu_torch.analysis import astlint, trace_audit
from luminaai_tpu_torch.monitoring.telemetry import MetricsRegistry

# rule -> (path under the repo where the rule looks, violating source)
GOLDEN = {
    "LX001": ("luminaai_tpu_torch/serving/bad.py",
              "from torch.distributed._composable.fsdp import fully_shard\n"),
    "LX002": ("luminaai_tpu_torch/models/bad.py", """
        from torch import nn

        class Block(nn.Module):
            def forward(self, x):
                return self._norm(x)

            def _norm(self, x):
                return x / x.abs().max().item()
        """),
    "LX004": ("luminaai_tpu_torch/ops/bad.py", """
        import time

        def jitter(x):
            return x * time.time()
        """),
    "LX005": ("luminaai_tpu_torch/models/bad.py", """
        import torch

        def noise(x):
            return x + torch.randn(x.shape)
        """),
    "LX007": ("luminaai_tpu_torch/models/bad.py", """
        from torch import nn

        class Layer(nn.Module):
            def __init__(self, sizes=[64, 64]):
                super().__init__()
        """),
    "LX008": ("luminaai_tpu_torch/training/bad.py", """
        def step(fn):
            try:
                return fn()
            except:
                return None
        """),
    "LX009": ("luminaai_tpu_torch/serving/bad.py", """
        def metrics(reg):
            return reg.counter("requests_total", "requests",
                               labelnames=("tenant",))
        """),
    "LX010": ("luminaai_tpu_torch/ops/bad.py", """
        import torch.distributed as dist

        def send(x, peer):
            return dist.isend(x, peer)
        """),
}


def _write(tmp_path, rule):
    rel, src = GOLDEN[rule]
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(src))
    return path


@pytest.mark.parametrize("rule", sorted(GOLDEN))
def test_rule_fires_on_its_golden_violation(tmp_path, rule, capsys):
    path = _write(tmp_path, rule)
    found = astlint.lint_paths([str(path)], rel_to=str(tmp_path))
    assert [f.rule for f in found] == [rule]
    assert not found[0].waived
    assert cli.main(["analyze", str(path), "--no-audit"]) == 1
    assert rule in capsys.readouterr().out


@pytest.mark.parametrize("rule", sorted(GOLDEN))
def test_rule_is_silent_outside_its_scope_or_when_waived(rule):
    rel, src = GOLDEN[rule]
    src = textwrap.dedent(src)
    found = astlint.lint_source(src, rel)
    line = found[0].line
    lines = src.splitlines()
    lines[line - 1] += f"  # lumina: disable={rule} -- golden fixture"
    waived = astlint.lint_source("\n".join(lines), rel)
    assert [f.waived for f in waived] == [True]
    assert waived[0].waiver_reason == "golden fixture"
    lines[line - 1] = lines[line - 1].replace(rule, "LX999")
    assert not astlint.lint_source("\n".join(lines), rel)[0].waived


@pytest.fixture(scope="module")
def repo_findings():
    import luminaai_tpu_torch

    return astlint.lint_paths([luminaai_tpu_torch.__path__[0]])


@pytest.mark.parametrize("rule", [r.id for r in astlint.ALL_RULES])
def test_rule_is_silent_on_the_repo(rule, repo_findings):
    found = [f for f in repo_findings if f.rule == rule]
    assert [f for f in found if not f.waived] == []
    assert all(f.waiver_reason for f in found)


def test_scoped_rules_stay_in_scope():
    """LX001/LX010 accept parallel/; LX002/LX004 look only at models/ and
    ops/; LX002 reaches helpers a forward calls, not other functions."""
    for rule in ("LX001", "LX010"):
        src = textwrap.dedent(GOLDEN[rule][1])
        assert not astlint.lint_source(src, "luminaai_tpu_torch/parallel/x.py")
    for rule in ("LX002", "LX004"):
        src = textwrap.dedent(GOLDEN[rule][1])
        assert not astlint.lint_source(src, "luminaai_tpu_torch/serving/x.py")
    cold = "def report(x):\n    return x.item()\n"
    assert not astlint.lint_source(cold, "luminaai_tpu_torch/models/x.py")


def test_baseline_round_trip(tmp_path, capsys):
    paths = [str(_write(tmp_path / r, r)) for r in ("LX008", "LX009")]
    base = tmp_path / "baseline.json"
    assert cli.main(["analyze", *paths, "--no-audit",
                     "--write-baseline", str(base)]) == 1
    accepted = json.loads(base.read_text())["accepted"]
    assert sorted(k.split(":")[0] for k in accepted) == ["LX008", "LX009"]
    assert set(accepted.values()) == {1}
    capsys.readouterr()
    assert cli.main(["analyze", *paths, "--no-audit", "--json",
                     "--baseline", str(base)]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["summary"]["baselined"] == 2 and doc["exit_code"] == 0
    assert all(f["baselined"] for f in doc["findings"])


def test_json_report_has_the_jax_keys(tmp_path, capsys):
    path = _write(tmp_path, "LX008")
    assert jcli.main(["analyze", str(path), "--json", "--no-audit"]) == 1
    want = json.loads(capsys.readouterr().out)
    assert cli.main(["analyze", str(path), "--json", "--no-audit"]) == 1
    got = json.loads(capsys.readouterr().out)
    assert set(got) == set(want)
    assert set(got["summary"]) == set(want["summary"])
    assert set(got["findings"][0]) == set(want["findings"][0])
    assert got["findings"][0]["rule"] == want["findings"][0]["rule"]


@pytest.fixture(scope="module")
def repo_report():
    """One whole `analyze --json` of the repo (lint and audits)."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = cli.main(["analyze", "--json"])
    return code, json.loads(out.getvalue())


def test_analyze_exits_0_on_the_repo(repo_report):
    code, doc = repo_report
    assert code == 0 and doc["exit_code"] == 0
    assert doc["summary"]["unwaived"] == 0
    assert {v["name"]: v["ok"] for v in doc["audit_verdicts"]} == {
        "host_syncs": True, "sharding_coverage": True}


def test_recompile_surface_pins(repo_report):
    programs = repo_report[1]["audits"]["recompile_surface"]["programs"]
    train, decode = programs["train"], programs["decode"]
    assert [v["variant"] for v in train["variants"]] == [
        "scan=off/einsum", "scan=off/gmm", "scan=on/einsum", "scan=on/gmm"]
    assert train["distinct_signatures"] == 4
    assert len(decode["variants"]) == 4
    assert decode["distinct_signatures"] == 3
    prefill = [v["signature"] for v in decode["variants"]
               if v["variant"].startswith("prefill/")]
    assert len(prefill) == 2 and len(set(prefill)) == 1


def test_sharding_coverage_is_complete(repo_report):
    cov = repo_report[1]["audits"]["sharding_coverage"]
    assert cov["coverage"] == 1.0 and cov["unannotated_leaves"] == 0


def test_detect_host_syncs_sees_what_waits():
    def fn(x):
        y = x[x > 0]
        torch.nonzero(x)
        return float(y.sum().item())

    rep = trace_audit.detect_host_syncs(fn, torch.arange(-2.0, 3.0))
    assert rep["by_op"] == {"aten.index": 1, "aten.nonzero": 1,
                            "aten._local_scalar_dense": 1}
    assert all(s["allowed"] is None for s in rep["sites"])


def test_a_crashing_audit_fails_its_verdict(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("lost its subject")

    monkeypatch.setattr(trace_audit, "enumerate_recompile_surface", boom)
    monkeypatch.setattr(trace_audit, "audit_sharding_coverage", boom)
    verdicts, report = trace_audit.run_audits(registry=MetricsRegistry())
    assert [(v.name, v.ok) for v in verdicts] == [
        ("host_syncs", False), ("sharding_coverage", False)]
    assert "lost its subject" in report["recompile_surface"]["error"]


def test_ep_dispatch_a2a_crosses_fewer_node_bytes_than_gather():
    reg = MetricsRegistry()
    out = trace_audit.audit_ep_dispatch(registry=reg)
    assert out["a2a"]["counts"] == {"all_to_all": 7, "psum": 3,
                                    "all_gather": 2}
    assert out["replicated_gather"]["counts"] == {"psum": 1}
    assert out["a2a"]["stages"]["dcn"] > 0
    assert 0 < out["a2a_dcn_bytes"] < out["gather_dcn_bytes"]
    assert out["a2a_below_gather"] is True
    assert reg.snapshot()["ep_dispatch_audit_dcn_bytes"] == {
        "path=a2a": float(out["a2a_dcn_bytes"]),
        "path=replicated_gather": float(out["gather_dcn_bytes"])}


def test_grad_reduce_hierarchical_crosses_fewer_node_bytes_than_flat():
    out = trace_audit.audit_grad_reduce(registry=MetricsRegistry())
    v = out["variants"]
    assert v["hierarchical/accum1"]["counts"]["reduce_scatter"] == 2
    assert v["hierarchical/accum1"]["counts"]["all_gather"] == 2
    assert "reduce_scatter" not in v["flat/accum1"]["counts"]
    assert out["hier_stages"]["dcn"] > 0
    assert 0 < out["hier_dcn_bytes"] < out["flat_dcn_bytes"]
    # The rail carries 1/ici of the gradient bytes, both ways.
    assert out["hier_dcn_bytes"] * 4 == out["flat_dcn_bytes"]
    assert out["hier_below_flat"] is True


def test_enumerate_collectives_records_the_mesh_wrappers():
    """psum, the tiled all-gather and ppermute through parallel/mesh.py
    on the fake 8-rank group: recorded with their bytes and tier, their
    outputs filled as identical ranks would."""
    import torch.distributed as dist

    from luminaai_tpu_torch.parallel import mesh

    x = torch.arange(6.0)
    with trace_audit._fake_world():
        whole = dist.new_group(list(range(8)))
        rail = dist.new_group([0, 4])

        def run():
            a = mesh.psum(x, rail)
            b = mesh.all_gather(x, whole)
            c = mesh.ppermute(x, whole, [(i, (i + 1) % 8) for i in range(8)])
            return a, b, c

        holder = {}
        rec = trace_audit.enumerate_collectives(
            lambda: holder.setdefault("out", run()))
    a, b, c = holder["out"]
    assert rec["counts"] == {"psum": 1, "all_gather": 1, "ppermute": 1}
    assert rec["bytes_by_primitive"] == {"psum": 24, "all_gather": 24,
                                         "ppermute": 24}
    assert [r["stage"] for r in rec["ops"]] == ["dcn", "flat", "flat"]
    assert torch.equal(a, x) and torch.equal(c, x)
    assert torch.equal(b, x.repeat(8))
