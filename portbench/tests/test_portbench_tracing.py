"""The trace reduction and the traffic generator, on made-up inputs."""
from portbench.traffic import Traffic
from portbench.tracing import HOST_PYTHON, Trace, short_name

PARAMS = {"snr_db": 1.5, "batch": 8, "error_blocks": 3,
          "pool": {"base_seed": 100, "points": 6}, "check": {"final_steps": 1,
          "other_steps": 1}, "trace": {"from_point": 0, "points": 1}}


def test_busy_union_and_idle_gaps_by_host_activity():
    t = Trace(0.0, 100.0,
              device=[("k1", 10.0, 30.0), ("k2", 20.0, 40.0), ("k3", 60.0, 70.0),
                      ("k1", 95.0, 120.0)],
              host=[("aten::to", 40.0, 50.0), ("cudaLaunchKernel", 55.0, 58.0)])
    assert t.busy_intervals() == [[10.0, 40.0], [60.0, 70.0], [95.0, 100.0]]
    assert t.busy_s == 45e-6 and t.window_s == 100e-6
    gaps = dict(t.idle_gaps())
    assert gaps["aten::to"] == 10e-6 and gaps["cudaLaunchKernel"] == 3e-6
    assert abs(gaps[HOST_PYTHON] - (10 + 7 + 25) * 1e-6) < 1e-12
    ops = dict(t.device_ops())
    assert abs(ops["k1"] - 45e-6) < 1e-12 and len(t.kernels("k1")) == 2


def test_short_names():
    assert short_name("void (anonymous namespace)::bp_decode_kernel<3, 10>(float const*, "
                      "float const*, signed char*, int, int, int)") == \
        "(anonymous namespace)::bp_decode_kernel<3, 10>"
    assert short_name("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD (Pageable -> Device)"


def test_every_seed_visits_the_same_pool():
    a, b = Traffic(PARAMS, 1), Traffic(PARAMS, 2**31 + 11)
    pa = [a.point(i) for i in range(12)]
    pb = [b.point(i) for i in range(12)]
    key = lambda p: (p.seed, p.snr_db)
    assert sorted(map(key, pa[:6])) == sorted(map(key, pb[:6])) == sorted(map(key, pa[6:]))
    assert {key(p) for p in pa} == {(100 + k, 1.5) for k in range(6)}
    assert [key(p) for p in pa] != [key(p) for p in pb]
    assert [key(p) for p in pa] == [key(Traffic(PARAMS, 1).point(i)) for i in range(12)]
