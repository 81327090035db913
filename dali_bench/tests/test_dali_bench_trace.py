"""The reduction of a device trace to busy time, kernel groups and idle
gaps, on made-up events."""
from dali_bench import trace


class Ev:
    def __init__(self, name, a, b, device="DeviceType.CUDA", user=False):
        self._n, self._a, self._b = name, a, b
        self._d, self._u = device, user

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return self._u


def test_busy_is_the_union_and_gaps_take_the_innermost_span():
    events = [Ev("ffn_gate_up_kernel<...>", 100, 300),
              Ev("Memcpy HtoD (Pinned -> Device)", 200, 500),  # overlaps
              Ev("elementwise_kernel", 700, 800),
              Ev("cudaLaunchKernel", 0, 1000, device="DeviceType.CPU"),
              Ev("gpu_user_annotation", 0, 1000, user=True),
              Ev("flash_kernel", 950, 1200)]                    # clipped
    spans = [(0, 1000, "steps.decode"), (520, 650, "store.read_misses")]
    r = trace.reduce(events, spans, 0, 1000)
    assert round(r["busy_s"] * 1e9) == 400 + 100 + 50
    assert r["window_s"] * 1e9 == 1000
    assert round(r["groups_s"]["K2 expert_ffn"] * 1e9) == 200
    assert round(r["groups_s"][trace.KERNEL_GROUPS[-1][0]] * 1e9) == 300
    assert round(r["groups_s"]["K3 flash_attention"] * 1e9) == 50
    idle = dict(r["breakdown"]["idle_gaps"])
    # gaps [0, 100), [500, 700) and [800, 950): the first and last inside
    # the decode span only, the middle one starting before read_misses
    assert round(idle["steps.decode"] * 1e9) == 100 + 200 + 150
    assert abs(trace.idle_share(r) - 45.0) < 1e-9


def test_a_gap_inside_a_nested_span_is_the_inner_spans():
    events = [Ev("gemm", 0, 10), Ev("gemm", 40, 50)]
    spans = [(0, 50, "steps.decode"), (5, 45, "store.fetch_weights")]
    r = trace.reduce(events, spans, 0, 50)
    assert list(dict(r["breakdown"]["idle_gaps"])) == ["store.fetch_weights"]
    assert round(r["breakdown"]["idle_gaps"][0][1] * 1e9) == 30
