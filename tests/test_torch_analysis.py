"""The port's replint (repro_torch.analysis): per-rule fixtures, parity
with the reference's replint, checks that each rule sees the real tree,
and the command line.

Most fixtures are one small port tree (``MINI_PORT``: a registry with one
primitive ``foo``, its plain version, its ``ctypes`` launcher, its CUDA
source and prototype, the hot roots, and a ``chip_smoke.py`` that calls
the launcher) that every rule passes; each bad fixture changes one file of
it, and the rule must fire there with the named message.  Where a rule's
contract is unchanged from the reference, the same fixture trees go
through both packages and must give the same findings.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
from test_analysis import (ALL_BAD, MAGLEV_PR4_BUG, RPL007_BAD,
                           _parity_tree, write_tree)

import repro.analysis as ref_lint
from repro_torch.analysis import (ALL_RULES, analyze, load_baseline,
                                  load_project, rule_by_id)
from repro_torch.analysis.baseline import render_baseline
from repro_torch.analysis.cli import default_paths, main
from repro_torch.analysis.core import registry_entries
from repro_torch.analysis.rules import hostsync, kernelhygiene, parity
from repro_torch.analysis.rules.dispatch import primitive_names

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"
BASELINE = REPO / "replint_torch_baseline.json"
# The port's suppression budget: lower it when the baseline shrinks;
# raising it is the reviewed act of adding a suppression.
BUDGET = 10


MINI_PORT = {
    "backend/ref.py": """\
        def crc16_bytes(data):
            return data

        def foo(x, n):
            return x
        """,
    "backend/registry.py": """\
        from repro_torch.backend import ref as R

        def _kernel(module, fn):
            def call(*args):
                import importlib
                mod = importlib.import_module(f"repro_torch.kernels.{module}")
                return getattr(mod, fn)(*args)
            return call

        _REGISTRY = {p.name: p for p in (
            Primitive("foo", R.foo, _kernel("foo", "foo_cuda"),
                      _kernel("foo", "foo")),
        )}
        """,
    "kernels/build.py": """\
        import ctypes

        SOURCES = ("foo.cu",)
        HEADERS = ("foo.cuh",)
        _vp, _i64, _i32, _f32 = (ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_int, ctypes.c_float)
        SIGNATURES = {
            "pp_foo": (_vp,) * 2 + (_i64, _i32, _f32, _vp),
        }

        def library():
            lib = ctypes.CDLL("libpp_kernels.so")
            for name, argtypes in SIGNATURES.items():
                getattr(lib, name).argtypes = list(argtypes)
            return lib

        def require_cuda(name, *tensors):
            if tensors[0].device.type != "cuda":
                raise RuntimeError(name)
            return tensors[0].device
        """,
    "kernels/foo.py": """\
        import torch

        from repro_torch.backend.ref import foo as foo_plain
        from repro_torch.kernels.build import library, require_cuda

        def blocks(x, n: int):
            return int(x.shape[0] * 2) + int(x.numel() // 4) + int(n * 3)

        def foo_cuda(x, n):
            dev = require_cuda("foo", x)
            out = torch.empty_like(x, device=dev)
            library().pp_foo(x.data_ptr(), out.data_ptr(), x.numel(), n,
                             1.0, 0)
            return out

        def foo(x, n):
            if x.device.type == "cpu":
                return foo_plain(x, n)
            return foo_cuda(x, n)
        """,
    "csrc/foo.cuh": """\
        #pragma once
        """,
    "csrc/foo.cu": """\
        #include "foo.cuh"
        // extern "C" int pp_commented_out(void* x);
        extern "C" int pp_foo(const void* x, void* out, int64_t n, int k,
                              float scale, void* stream) {
          return 0;
        }
        """,
    "core/header.py": """\
        from repro_torch.backend.registry import dispatch

        def foo(x, n, backend=None):
            return dispatch("foo", backend)(x, n)
        """,
    "core/park.py": """\
        from repro_torch.backend.registry import dispatch

        def split_fn(cfg, state, pkts, backend=None):
            return state, dispatch("foo", backend)(pkts, 1)

        def recirc_fn(cfg, state, pkts, backend=None):
            return split_fn(cfg, state, pkts, backend=backend)

        def merge_fn(cfg, state, pkts, backend=None):
            return state, pkts

        def stats(state):
            return {"occupancy": int(state.occ.sum())}
        """,
    "nf/chain.py": """\
        from repro_torch.backend.registry import dispatch
        from repro_torch.core.header import foo

        class NF:
            def __call__(self, state, pkts, backend=None):
                return Chain((self,)).run((state,), pkts, backend=backend)

        class Chain:
            def run(self, states, pkts, backend=None):
                out = dispatch("foo", backend)(pkts, 2)
                return states, foo(out, 3, backend=backend)

            def cycle_costs(self, probe):
                return float(probe.sum())
        """,
    "switchsim/engine.py": """\
        import numpy as np

        def _alive(p):
            return p.alive.sum(-1)

        def scan_step(cfg, chain, window):
            def step(carry, xs):
                return carry, dict(wire_pkts=_alive(xs))
            return step

        class _ShardRun:
            def step(self, t):
                self.carry, ys = self.step_fn(self.carry, t)

            def finish(self):
                return int(np.asarray(self.tally).max()), self.occ.item()
        """,
    "chip_smoke.py": """\
        from repro_torch.kernels import foo

        def main(x):
            return foo.foo_cuda(x, 3)
        """,
}


def mini_port(changes: dict[str, str | None]) -> dict[str, str]:
    """MINI_PORT with files replaced or, for a value of None, removed."""
    files = {**MINI_PORT, **changes}
    return {rel: text for rel, text in files.items() if text is not None}


def run_port(tmp_path: Path, files: dict[str, str], rule_id=None):
    write_tree(tmp_path, files)
    rules = [rule_by_id(rule_id)] if rule_id else ALL_RULES
    return analyze(load_project([tmp_path], root=tmp_path), rules)


def test_mini_port_is_clean_under_every_rule(tmp_path):
    """The fixed twin of every bad fixture below: the backend= wrapper,
    host-side finalizes beside hot code, casts of host values in a kernel
    planner, a commented-out prototype and the loader in build.py."""
    assert run_port(tmp_path, MINI_PORT) == []


def _edit(rel: str, old: str, new: str) -> str:
    text = textwrap.dedent(MINI_PORT[rel])
    assert old in text, old
    return text.replace(old, new)


# (rule, changed files, expected findings as (path, message fragment))
BAD = {
    # RPL001: the primitive set comes from the registry (foo is no name
    # the rule knows), launchers and ref.py helpers included
    "rpl001-registry-primitive": ("RPL001", {"nf/fw.py": """\
        from repro_torch.backend.ref import foo

        def route(x):
            return foo(x, 1)
        """}, [("nf/fw.py", "imports primitive 'foo'"),
               ("nf/fw.py", "direct call to primitive 'foo'")]),
    "rpl001-launcher-import": ("RPL001", {"nf/fw.py": """\
        from repro_torch.kernels.foo import foo_cuda

        def route(x):
            return foo_cuda(x, 1)
        """}, [("nf/fw.py", "imports primitive 'foo_cuda'"),
               ("nf/fw.py", "direct call to primitive 'foo_cuda'")]),
    "rpl001-ref-helper": ("RPL001", {"nf/fw.py": """\
        from repro_torch.backend.ref import crc16_bytes
        """}, [("nf/fw.py", "imports primitive 'crc16_bytes'")]),
    # RPL003: the port's wall clocks and global generators
    "rpl003-perf-counter": ("RPL003", {"launch/run.py": """\
        import time
        from time import monotonic as mono

        def timed(f):
            t0 = time.perf_counter()
            f()
            return time.perf_counter() - t0, mono()
        """}, [("launch/run.py", "time.perf_counter()"),
               ("launch/run.py", "time.perf_counter()"),
               ("launch/run.py", "time.monotonic()")]),
    "rpl003-global-rng": ("RPL003", {"traffic/gen.py": """\
        import numpy as np
        import torch

        def draw(x):
            torch.manual_seed(0)
            np.random.seed(0)
            x.uniform_()
            return torch.randint(0, 9, (4,)), np.random.rand(3)
        """}, [("traffic/gen.py", "torch.manual_seed() reseeds"),
               ("traffic/gen.py", "np.random.seed() uses numpy"),
               ("traffic/gen.py", ".uniform_() without generator="),
               ("traffic/gen.py", "torch.randint() without generator="),
               ("traffic/gen.py", "np.random.rand() uses numpy")]),
    # RPL004: the digest covers every csrc file; one loader
    "rpl004-header-not-hashed": ("RPL004", {"csrc/bar.cuh": """\
        #pragma once
        """}, [("csrc/bar.cuh", "neither SOURCES nor HEADERS")]),
    "rpl004-source-not-built": ("RPL004", {"csrc/bar.cu": """\
        #include "foo.cuh"
        """}, [("csrc/bar.cu", "neither SOURCES nor HEADERS")]),
    "rpl004-second-loader": ("RPL004", {"kernels/fast.py": """\
        import ctypes
        import subprocess

        from torch.utils.cpp_extension import load_inline

        def build(src):
            subprocess.run(["nvcc", "-c", src], check=True)
            ext = load_inline("x", "", cuda_sources=[src])
            return ctypes.CDLL("libfast.so"), ext
        """}, [("kernels/fast.py", "subprocess.run(nvcc ...)"),
               ("kernels/fast.py", "load_inline outside"),
               ("kernels/fast.py", "ctypes.CDLL outside")]),
    # RPL005: syncs reached from the named roots
    "rpl005-item-in-step": ("RPL005", {"switchsim/engine.py": _edit(
        "switchsim/engine.py", "return carry, dict(",
        "n = xs.alive.sum().item()\n        return carry, dict(")},
        [("switchsim/engine.py", ".item() waits for the card")]),
    "rpl005-helper-by-bare-name": ("RPL005", {"core/park.py": _edit(
        "core/park.py", "return state, pkts\n",
        "return state, _count(pkts)\n\ndef _count(p):\n"
        "    return int(p.alive.sum())\n")},
        [("core/park.py", "int() of a computed value")]),
    "rpl005-self-method": ("RPL005", {"switchsim/engine.py": _edit(
        "switchsim/engine.py", "self.step_fn(self.carry, t)",
        "self.step_fn(self.carry, self._t())\n\n"
        "    def _t(self):\n        return self.t.cpu()")},
        [("switchsim/engine.py", ".cpu() waits for the card")]),
    "rpl005-kernel-public-fn": ("RPL005", {"kernels/foo.py": _edit(
        "kernels/foo.py", "return out\n",
        "torch.cuda.synchronize()\n    keep = torch.where(out > 0)\n"
        "    return np.asarray(out.nonzero()), keep\n")},
        [("kernels/foo.py", ".synchronize() waits"),
         ("kernels/foo.py", "one-argument torch.where"),
         ("kernels/foo.py", "np.asarray() on the hot path"),
         ("kernels/foo.py", "nonzero() has a data-dependent")]),
    "rpl005-root-renamed": ("RPL005", {"core/park.py": _edit(
        "core/park.py", "def merge_fn(", "def merge_fn2(")},
        [("core/park.py", "hot root 'merge_fn' is gone")]),
    "rpl005-module-gone": ("RPL005", {"nf/chain.py": None},
                           [("nf/chain.py", "hot root 'NF.__call__'"),
                            ("nf/chain.py", "hot root 'Chain.run'")]),
    # RPL006: registry pairs, ctypes table, fallbacks, the harness
    "rpl006-width-mismatch": ("RPL006", {"kernels/build.py": _edit(
        "kernels/build.py", "(_i64, _i32, _f32, _vp)",
        "(_i32, _i32, _f32, _vp)")},
        [("kernels/build.py", "argument 2 is c_int; its prototype "
                              "(foo.cu) wants c_int64")]),
    "rpl006-arity-mismatch": ("RPL006", {"kernels/build.py": _edit(
        "kernels/build.py", "(_i64, _i32, _f32, _vp)", "(_i64, _i32, _vp)")},
        [("kernels/build.py", "has 5 arguments; its prototype (foo.cu) "
                              "has 6")]),
    "rpl006-prototype-without-entry": ("RPL006", {"csrc/foo.cu": _edit(
        "csrc/foo.cu", "#include", 'extern "C" int pp_bar(void* x) '
        "{ return 0; }\n#include")},
        [("csrc/foo.cu", "pp_bar has no SIGNATURES entry")]),
    "rpl006-entry-without-prototype": ("RPL006", {"kernels/build.py": _edit(
        "kernels/build.py", '"pp_foo": ',
        '"pp_gone": (_vp,),\n    "pp_foo": ')},
        [("kernels/build.py", "'pp_gone' has no extern")]),
    "rpl006-except-fallback": ("RPL006", {"kernels/foo.py": _edit(
        "kernels/foo.py", '    dev = require_cuda("foo", x)\n',
        '    try:\n        dev = require_cuda("foo", x)\n'
        "    except RuntimeError:\n        return foo_plain(x, n)\n")},
        [("kernels/foo.py", "except handler falls back")]),
    "rpl006-except-pass": ("RPL006", {"backend/registry.py": _edit(
        "backend/registry.py", "        return getattr(mod, fn)(*args)",
        "        try:\n            return getattr(mod, fn)(*args)\n"
        "        except OSError:\n            pass")},
        [("backend/registry.py", "except handler falls back")]),
    "rpl006-no-require-cuda": ("RPL006", {"kernels/foo.py": _edit(
        "kernels/foo.py", 'dev = require_cuda("foo", x)', "dev = x.device")},
        [("kernels/foo.py", "'foo_cuda' never calls require_cuda")]),
    "rpl006-launcher-not-in-harness": ("RPL006", {"chip_smoke.py": _edit(
        "chip_smoke.py", "foo.foo_cuda(x, 3)", "foo.foo(x, 3)")},
        [("backend/registry.py", "'foo_cuda' is not called in "
                                 "chip_smoke.py")]),
    "rpl006-no-harness": ("RPL006", {"chip_smoke.py": None},
                          [("backend/registry.py", "'foo_cuda' is not "
                                                   "called")]),
    "rpl006-launcher-signature": ("RPL006", {"kernels/foo.py": _edit(
        "kernels/foo.py", "def foo_cuda(x, n):", "def foo_cuda(x, n, m):")},
        [("kernels/foo.py", "launcher 'foo_cuda' takes ['x', 'n', 'm']")]),
    "rpl006-registry-names-missing": ("RPL006", {"backend/registry.py": _edit(
        "backend/registry.py", '"foo_cuda"', '"foo_kernel"')},
        [("backend/registry.py", "kernels/foo.py::foo_kernel, which does "
                                 "not exist"),
         ("backend/registry.py", "'foo_kernel' is not called")]),
    # RPL007: bit_for_bit is an exactness word; zero tolerances are exact
    "rpl007-assert-close-bit-for-bit": ("RPL007", {"tests/test_foo.py": """\
        import torch

        def test_foo_matches_plain_bit_for_bit():
            torch.testing.assert_close(torch.ones(2), torch.ones(2))
            torch.testing.assert_close(torch.ones(2), torch.ones(2), rtol=0)
        """}, [("tests/test_foo.py", "assert_close() in a bit-exactness"),
               ("tests/test_foo.py", "assert_close() in a bit-exactness")]),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_rule_fires_on_its_fixture(tmp_path, case):
    rule, changes, expected = BAD[case]
    findings = run_port(tmp_path, mini_port(changes), rule)
    assert len(findings) == len(expected), [f.render() for f in findings]
    for path, fragment in expected:
        assert any(f.path == path and fragment in f.message
                   for f in findings), (path, fragment,
                                        [f.render() for f in findings])
    # nothing else in the tree trips any other rule
    others = [f for f in run_port(tmp_path, {}) if f.rule != rule]
    assert others == [], [f.render() for f in others]


GOOD = {
    "rpl003-timing-in-tests": {"tests/test_time.py": """\
        import time

        def test_timing():
            t0 = time.perf_counter()
            assert time.perf_counter() >= t0
        """},
    "rpl003-seeded-generators": {"traffic/gen.py": """\
        import numpy as np
        import torch

        def draw(x, seed):
            g = torch.Generator().manual_seed(seed)
            x.uniform_(generator=g)
            rng = np.random.default_rng(np.random.SeedSequence(seed))
            return torch.randint(0, 9, (4,), generator=g), rng.random(3)
        """},
    "rpl006-require-cuda-through-helper": {"kernels/foo.py": _edit(
        "kernels/foo.py", 'dev = require_cuda("foo", x)', "dev = _dev(x)"
    ) + "\ndef _dev(x):\n    return require_cuda('foo', x)\n"},
    "rpl006-except-reraises": {"kernels/foo.py": _edit(
        "kernels/foo.py", '    dev = require_cuda("foo", x)\n',
        '    try:\n        dev = require_cuda("foo", x)\n'
        "    except RuntimeError as e:\n"
        '        raise ValueError("foo") from e\n')},
    "rpl007-zero-tolerances": {"tests/test_foo.py": """\
        import pytest
        import torch

        def test_foo_matches_plain_bit_for_bit():
            torch.testing.assert_close(torch.ones(2), torch.ones(2),
                                       rtol=0, atol=0)
            assert 1.0 == pytest.approx(1.0, rel=0, abs=0)

        def test_attention_close_enough():
            torch.testing.assert_close(torch.ones(2), torch.ones(2),
                                       rtol=1e-3, atol=1e-3)
        """},
}


@pytest.mark.parametrize("case", sorted(GOOD))
def test_rules_silent_on_fixed_twin(tmp_path, case):
    findings = run_port(tmp_path, mini_port(GOOD[case]))
    assert findings == [], [f.render() for f in findings]


# ---------------------------------------------------------------------------
# Held against the reference where the contract did not change
# ---------------------------------------------------------------------------

RPL003_WALLCLOCK_AND_SET = {"core/build.py": """\
    import time

    def stamp():
        return time.time()

    def order(names):
        out = []
        for n in set(names):
            out.append(n)
        return out
    """}

RPL004_NONFROZEN = {"serving/engine.py": """\
    import dataclasses

    @dataclasses.dataclass
    class EngineConfig:
        max_batch: int = 8
    """}

SAME_AS_REFERENCE = {
    "rpl002-engine-only-counter": ("RPL002", _parity_tree(
        engine_extra='    state = C.bump(state, "injected_counter", 1)')),
    "rpl002-loop-only-counter": ("RPL002", _parity_tree(
        loop_extra='    state = bump(state, "loop_only", 1)')),
    "rpl002-unmirrored-field": ("RPL002", {
        **_parity_tree(),
        "switchsim/telemetry.py": """\
            import dataclasses

            @dataclasses.dataclass(frozen=True)
            class LinkTelemetry:
                wire_pkts: int = 0
                wire_bytes: int = 0
                recirc_pkts: int = 0
            """}),
    "rpl003-pr4-maglev-hash": ("RPL003", MAGLEV_PR4_BUG),
    "rpl003-wallclock-and-set": ("RPL003", RPL003_WALLCLOCK_AND_SET),
    "rpl004-nonfrozen-config": ("RPL004", RPL004_NONFROZEN),
    "rpl004-nonfrozen-config-cli-fixture": ("RPL004", ALL_BAD["RPL004"]),
    "rpl007-allclose-in-oracle": ("RPL007", RPL007_BAD),
}


def _keys(findings):
    return [(f.path, f.line, f.rule, f.fingerprint) for f in findings]


@pytest.mark.parametrize("case", sorted(SAME_AS_REFERENCE))
def test_same_findings_as_reference(tmp_path, case):
    rule, files = SAME_AS_REFERENCE[case]
    write_tree(tmp_path, files)
    ours = analyze(load_project([tmp_path], root=tmp_path),
                   [rule_by_id(rule)])
    theirs = ref_lint.analyze(ref_lint.load_project([tmp_path], root=tmp_path),
                              [ref_lint.rule_by_id(rule)])
    assert ours, case
    assert _keys(ours) == _keys(theirs)


def test_rpl002_silent_when_mirrored(tmp_path):
    write_tree(tmp_path, _parity_tree())
    assert analyze(load_project([tmp_path], root=tmp_path),
                   [rule_by_id("RPL002")]) == []


# ---------------------------------------------------------------------------
# Each rule sees the real tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port():
    return load_project([PKG], root=REPO)


def test_real_tree_has_one_port_root(port):
    assert port.port_roots() == [PKG.resolve()]


def test_rpl001_reads_every_primitive_from_the_registry():
    names = primitive_names(PKG)
    # the four the reference's hand-kept list lacks, and every launcher
    assert {"split_control", "merge_stage", "nf_chain",
            "paged_decode_attention"} <= names
    assert {"crc16_bytes", "tag_bytes", "maglev_hash5"} <= names
    assert sum(n.endswith("_cuda") for n in names) == 9


def test_rpl002_sees_the_counters_and_telemetry_fields(port):
    eng = port.find("switchsim/engine.py")
    assert set(parity.bumped_counters(eng.tree)) == {
        "recirc_budget_drops", "fault_drops"}
    fields = parity.tel_fields(port.find("switchsim/telemetry.py"))
    assert len(fields) == 10
    assert fields <= set(parity.engine_ys_keys(eng))
    loops = parity.loop_functions(port.find("switchsim/simulate.py"))
    assert {fn.name for fn in loops} == {"simulate_loop",
                                         "_simulate_loop_recirc"}
    assert fields <= set(parity.loop_tel_keys(loops))


def test_rpl005_every_hot_root_resolves(port):
    hot, missing = hostsync.hot_functions(port, PKG)
    assert missing == []
    names = {(f.path.split("repro_torch/")[1], fn.name)
             for f, fns in hot for fn in fns}
    for rel, qual in hostsync.HOT_ROOTS:
        assert (rel, qual.split(".")[-1]) in names
    kernel_modules = {f.path for f, _ in hot if "/kernels/" in f.path}
    assert len(kernel_modules) == 9
    # the closure reaches helpers called by bare name and nested bodies
    assert ("switchsim/engine.py", "recirc_select") in names
    assert ("core/park.py", "_payload_shift") in names
    assert ("kernels/nf_chain.py", "_launch") in names


def test_rpl006_pairs_every_primitive_and_signature(port):
    entries = registry_entries(port.load(PKG / "backend" / "registry.py"))
    assert len(entries) == 9
    table = kernelhygiene.signature_table(port.load(PKG / "kernels" /
                                                    "build.py"))
    protos = kernelhygiene.c_prototypes(PKG / "csrc")
    assert len(table) == len(protos) == 9
    for name, (types, _) in table.items():
        assert types == protos[name][0], name
    assert {e.cuda for e in entries} == {
        f"{e.ref}_cuda" for e in entries}


# ---------------------------------------------------------------------------
# The committed tree, the baseline and the command line
# ---------------------------------------------------------------------------

def test_port_tree_is_clean_under_its_baseline(monkeypatch, tmp_path):
    """The acceptance criterion, as a test: the port and its tests lint
    clean under the committed baseline, with no stale entry, every finding
    is a baselined one, and the baseline stays within its budget."""
    monkeypatch.chdir(REPO)
    paths = default_paths()
    assert paths[0] == "src/repro_torch"
    assert "tests/test_torch_analysis.py" in paths
    report = tmp_path / "replint.json"
    assert main([*paths, "--json", str(report)]) == 0
    data = json.loads(report.read_text())
    baseline = load_baseline(BASELINE)
    assert data["baseline_count"] == len(baseline) <= BUDGET
    assert data["findings"] == data["stale_baseline"] == []
    # what --no-baseline would list is exactly the baselined findings
    assert sorted(f["fingerprint"] for f in data["suppressed"]) == sorted(
        e.fingerprint for e in baseline.entries)


def test_cli_exit_codes_and_json_report(tmp_path, capsys):
    write_tree(tmp_path, MINI_PORT)
    report = tmp_path / "replint.json"
    assert main([str(tmp_path), "--no-baseline", "--json",
                 str(report)]) == 0
    data = json.loads(report.read_text())
    assert set(data) == {"findings", "suppressed", "stale_baseline",
                         "baseline_count", "files_analyzed"}
    assert data["files_analyzed"] == len(
        [p for p in MINI_PORT if p.endswith(".py")])
    write_tree(tmp_path, mini_port(BAD["rpl001-registry-primitive"][1]))
    assert main([str(tmp_path), "--no-baseline"]) == 1
    assert "RPL001" in capsys.readouterr().out
    assert main([str(tmp_path), "--no-baseline", "--select",
                 "RPL003,RPL007"]) == 0
    assert main([str(tmp_path), "--select", "RPL999"]) == 2
    capsys.readouterr()
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert [line.split()[0] for line in out.splitlines()] == [
        f"RPL00{i}" for i in range(1, 8)]


def test_baseline_suppresses_then_goes_stale(tmp_path, monkeypatch, capsys):
    write_tree(tmp_path, mini_port(BAD["rpl001-registry-primitive"][1]))
    monkeypatch.chdir(tmp_path)
    findings = analyze(load_project(["."]), ALL_RULES)
    assert findings
    bl = tmp_path / "bl.json"
    bl.write_text(json.dumps({"suppressions": [
        {"fingerprint": f.fingerprint, "rule": f.rule, "path": f.path,
         "justification": "fixture exemption"} for f in findings]}))
    assert main([".", "--baseline", str(bl)]) == 0
    (tmp_path / "nf" / "fw.py").write_text("X = 1\n")
    rc = main([".", "--baseline", str(bl)])
    out = capsys.readouterr().out
    assert rc == 1 and "STALE" in out


def test_baseline_rejects_empty_justification(tmp_path, capsys):
    write_tree(tmp_path, mini_port(BAD["rpl001-registry-primitive"][1]))
    findings = analyze(load_project([tmp_path], root=tmp_path), ALL_RULES)
    bl = tmp_path / "bl.json"
    bl.write_text(render_baseline(findings))  # skeleton: justifications empty
    with pytest.raises(ValueError, match="justification"):
        load_baseline(bl)
    assert main([str(tmp_path), "--baseline", str(bl)]) == 2


def test_fingerprints_survive_line_drift_not_content_change(tmp_path):
    files = mini_port(BAD["rpl001-registry-primitive"][1])
    before = run_port(tmp_path, files)
    src = (tmp_path / "nf" / "fw.py").read_text()
    (tmp_path / "nf" / "fw.py").write_text("# a leading comment\n" + src)
    after = analyze(load_project([tmp_path], root=tmp_path), ALL_RULES)
    assert {f.fingerprint for f in before} == {f.fingerprint for f in after}
    assert [f.line for f in before] != [f.line for f in after]
    (tmp_path / "nf" / "fw.py").write_text(src.replace("foo(x, 1)",
                                                       "foo(x, 2)"))
    changed = analyze(load_project([tmp_path], root=tmp_path), ALL_RULES)
    assert {f.fingerprint for f in before} != {f.fingerprint for f in changed}


def test_package_loads_neither_framework_nor_reference():
    code = ("import sys, repro_torch.analysis, repro_torch.analysis.cli\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib', 'repro', 'numpy'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           "--list-rules"], capture_output=True, text=True,
                          env=env, timeout=60, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert len(proc.stdout.splitlines()) == 7
