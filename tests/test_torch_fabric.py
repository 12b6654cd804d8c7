"""The port's fabric sharding (``repro_torch.switchsim.fabric``, DESIGN.md
§12) against its own single-device runs and the reference's.

Shard-count invariance is the contract: the same scenario run with its
pipe axis sharded over 1, 2 or 8 logical devices gives bit-identical
counters, telemetry, NF counters and occupancy, and the engine≡loop
oracle holds per shard.  Logical devices stand in for the reference's
forced host devices (``repro_torch.distributed.force_host_devices``); on
the CPU all of them run on the one CPU, in process, so nothing here
spawns.  The geometry is ``tests/test_fabric.py``'s: 512 packets, chunk
64, window 2, pmax 512, capacity 256.
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.scenarios as JS  # noqa: E402
import repro_torch.scenarios as TS  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch import distributed as D  # noqa: E402
from repro_torch.scenarios.spec import compile_key  # noqa: E402
from repro_torch.switchsim import engine as TE  # noqa: E402
from repro_torch.switchsim import fabric  # noqa: E402


def point(pkg, pipes, devices, packets=512, **kw):
    extra = {} if pkg is JS else dict(backends=("auto",))
    return pkg.pipeline_grid([pipes], packets=packets, chunk=64, window=2,
                             pmax=512, capacity=256, devices=(devices,),
                             **extra, **kw)[0]


def same(a, b) -> bool:
    return (a.counters == b.counters
            and a.per_pipe_counters == b.per_pipe_counters
            and a.telemetry == b.telemetry
            and a.per_pipe_telemetry == b.per_pipe_telemetry
            and a.nf_counters == b.nf_counters
            and a.per_pipe_nf_counters == b.per_pipe_nf_counters
            and a.per_pipe_peak_occupancy == b.per_pipe_peak_occupancy
            and np.array_equal(np.asarray(a.per_pipe_occ_series),
                               np.asarray(b.per_pipe_occ_series)))


@pytest.fixture
def host_devices():
    """Eight logical devices for the test; the count before it restored
    after."""
    saved = D.forced_host_devices()
    D.force_host_devices(8)
    yield 8
    D.force_host_devices(saved)


def run(spec):
    return TS.run_matrix([spec], device="cpu")[0]


def test_shard_count_invariance_1_2_8(host_devices):
    """Bit-identical counters/telemetry/occupancy on 1, 2 and 8 devices,
    with the engine≡loop oracle green per shard."""
    assert fabric.fabric_devices("cpu") == 8
    res = {d: run(point(TS, 8, d)) for d in (1, 2, 8)}
    for d in (2, 8):
        assert same(res[d], res[1]), f"devices={d} diverged from devices=1"
        TS.verify_oracle(res[d], device="cpu")


@pytest.mark.parametrize("recirc", [False, True])
def test_per_shard_oracle_recirc_modes(host_devices, recirc):
    spec = dataclasses.replace(point(TS, 4, 2), name=f"fab_{int(recirc)}",
                               recirc=recirc)
    res = run(spec)
    TS.verify_oracle(res, device="cpu")
    assert same(res, run(dataclasses.replace(spec, devices=1)))


def test_oracle_names_the_shard(host_devices):
    res = run(point(TS, 4, 2))
    rows = [dict(r) for r in res.per_pipe_counters]
    rows[3]["splits"] += 1
    with pytest.raises(TS.OracleMismatch, match=r"pipe 3 \(shard 1/2\)"):
        TS.verify_oracle(dataclasses.replace(res, per_pipe_counters=rows),
                         device="cpu")


def test_non_dividing_pipe_count_falls_back(host_devices):
    """pipes=3 over 2 devices warns and equals the single-device run."""
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        r3 = run(point(TS, 3, 2, packets=384))
    assert any("does not divide" in str(x.message) for x in w), \
        [str(x.message) for x in w]
    assert same(r3, run(point(TS, 3, 1, packets=384)))


def test_more_devices_than_visible_falls_back():
    """Requesting more devices than visible warns and runs replicated."""
    saved = D.forced_host_devices()
    D.force_host_devices(2)
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            r = run(point(TS, 2, 4))
        assert any("only 2 visible" in str(x.message) for x in w), \
            [str(x.message) for x in w]
        assert same(r, run(point(TS, 2, 1)))
    finally:
        D.force_host_devices(saved)


def test_run_matrix_group_spans_devices(host_devices):
    """Two same-compile-key specs at devices=2 batch into one sharded run
    (their concatenated pipe axis spans the devices) and match their solo
    runs bit for bit."""
    a = dataclasses.replace(point(TS, 2, 2), name="a", seed=0, flows=256)
    b = dataclasses.replace(point(TS, 2, 2), name="b", seed=7, flows=256)
    together = TS.run_matrix([a, b], device="cpu")
    assert together[0].group_size == 2, "specs did not share a group"
    for got, spec in zip(together, (a, b)):
        assert same(got, run(spec)), got.spec.name


def test_run_pipes_shards_keep_outputs_on_the_device(host_devices):
    """run_pipes itself: the merged packets, final state and NF counters
    of a 4-pipe run over 4 devices equal the single-device run's."""
    spec = point(TS, 4, 1)
    p = TS.prepare(spec)
    kw = dict(window=spec.window, device="cpu")
    one = TE.run_pipes(spec.park_config(), p.chain, p.traces, **kw)
    four = TE.run_pipes(spec.park_config(), p.chain, p.traces, devices=4,
                        **kw)
    for k, v in CV.as_numpy(one.merged).items():
        assert np.array_equal(v, CV.as_numpy(four.merged)[k]), k
    for f in dataclasses.fields(one.state):
        assert torch.equal(getattr(one.state, f.name),
                           getattr(four.state, f.name)), f.name
    assert four.per_pipe_nf_counters == one.per_pipe_nf_counters
    assert four.peak_occupancy == one.peak_occupancy


def test_sharded_point_equals_reference_single_device(host_devices):
    """The reference's devices=1 run of a point (its own sharded run fails
    on this jax, ROADMAP C0b) against the port's 8-device run of the same
    prepared inputs, bit for bit."""
    ref = JS.run_matrix([point(JS, 8, 1)])[0]
    prep = CV.prepared(ref.prepared)
    prep = dataclasses.replace(
        prep, spec=dataclasses.replace(prep.spec, devices=8))
    got = TS.run_prepared([prep], device="cpu")[0]
    assert got.counters == ref.counters
    assert got.per_pipe_counters == ref.per_pipe_counters
    assert got.telemetry.as_dict() == ref.telemetry.as_dict()
    assert [x.as_dict() for x in got.per_pipe_telemetry] == \
        [x.as_dict() for x in ref.per_pipe_telemetry]
    assert got.per_pipe_nf_counters == ref.per_pipe_nf_counters
    assert got.per_pipe_peak_occupancy == ref.per_pipe_peak_occupancy
    assert np.array_equal(np.asarray(got.per_pipe_occ_series),
                          np.asarray(ref.per_pipe_occ_series))
    assert got.gain == ref.gain


def test_spec_devices_validation_and_compile_key():
    """devices is validated and separates compile groups."""
    base = TS.pipeline_grid([2], packets=128, chunk=64, window=2, pmax=512,
                            capacity=256)[0]
    with pytest.raises(ValueError, match="devices"):
        dataclasses.replace(base, devices=0)
    pkts = TS.make_packets(base)
    chain = TS.build_chain(base, pkts)
    k1 = compile_key(base, chain, steps=2)
    k2 = compile_key(dataclasses.replace(base, devices=2), chain, steps=2)
    assert k1 != k2
    assert k1 == compile_key(dataclasses.replace(base, seed=5), chain,
                             steps=2)


def test_resolve_devices_guards():
    """Trivial counts short-circuit; an oversubscribed request falls back
    with a warning (one logical device on the CPU unless forced)."""
    assert D.forced_host_devices() is None
    assert fabric.resolve_devices(8, None, "cpu") == 1
    assert fabric.resolve_devices(8, 1, "cpu") == 1
    assert fabric.resolve_devices(8, 0, "cpu") == 1
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert fabric.resolve_devices(8, 2, "cpu") == 1
    assert any("only 1 visible" in str(x.message) for x in w)


def test_force_host_devices_count_and_mapping():
    saved = D.forced_host_devices()
    with pytest.raises(ValueError):
        D.force_host_devices(0)
    assert D.forced_host_devices() == saved
    try:
        D.force_host_devices(5)
        assert fabric.fabric_devices("cpu") == 5
        assert fabric.resolve_devices(10, 5, "cpu") == 5
        cpu = torch.device("cpu")
        assert {D.physical_device(i, cpu) for i in range(5)} == {cpu}
    finally:
        D.force_host_devices(saved)
    assert fabric.fabric_devices("cpu") == 1
    assert fabric.shard_bounds(8, 4) == [(0, 2), (2, 4), (4, 6), (6, 8)]
