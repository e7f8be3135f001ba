"""The harness: its look for JAX, its refusal without a card, cells found
by name from files alone, and whole runs on the CPU (the port's plain
PyTorch path) at a small size, with one matrix as the cells have and with
a mix of several."""
import importlib.util
import json
import shutil
import subprocess
import sys
import time

import pytest

from harness.cell import run_cell
from harness.spec import ROOT, load_cell

_GRID = {"generator": "poisson_2d", "nx": 12}
_RANDOM = {"generator": "diag_dominant_spd", "n": 144, "nnz_per_row": 10,
           "dominance": 1.1, "seed": 4}
#: A case: a cell of BENCHMARK.json, run on these matrices.
SMALL = {"ecology2.rhs_stream": ("ecology2.rhs_stream", [_GRID]),
         "ecology2.engine_stream": ("ecology2.engine_stream", [_GRID]),
         "mix.rhs_stream": ("ecology2.rhs_stream", [_GRID, _RANDOM]),
         "mix.engine_stream": ("ecology2.engine_stream", [_GRID, _RANDOM])}


def small_cell(case, root=ROOT):
    name, matrices = SMALL[case]
    cell = load_cell(name, root)
    cell.config["matrices"] = matrices
    return cell


def _run_module():
    spec = importlib.util.spec_from_file_location("bench_run",
                                                  ROOT / "bench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_forbidden_modules_compare_whole_top_level_names():
    forbidden = _run_module().forbidden_modules
    assert forbidden(["repro_torch", "repro_torch.core", "reproduce",
                      "jax_utils", "flaxen", "numpy"]) == []
    assert forbidden(["repro", "repro.core.cg"]) == ["repro"]
    assert forbidden(["jax.numpy", "jaxlib", "flax.linen",
                      "torch"]) == ["flax", "jax", "jaxlib"]


def test_a_run_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c",
         "import json, sys; sys.path[:0] = ['bench', 'src']\n"
         "import harness.cell, reference.jpcg\n"
         "from harness.spec import load_cell\n"
         "for w in json.load(open('BENCHMARK.json'))['workloads']:\n"
         "    load_cell(w['name'])\n"
         "import repro_torch.core.cg, repro_torch.serve, "
         "repro_torch.kernels.ops\n"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, check=True)
    loaded = set(eval(out.stdout))
    assert loaded.isdisjoint({"jax", "jaxlib", "flax", "repro"})


@pytest.mark.parametrize("only_bench", [False, True])
def test_no_card_no_result(tmp_path, only_bench):
    """Without a CUDA device (this machine), or in a directory holding only
    the benchmark's files, a run exits non-zero and prints nothing."""
    cwd = ROOT
    if only_bench:
        cwd = tmp_path
        shutil.copy(ROOT / "BENCHMARK.json", cwd)
        shutil.copytree(ROOT / "bench", cwd / "bench",
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "ecology2.rhs_stream",
         "--seed", "2147483900", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""


#: Readers with nothing to read on the CPU (no CUDA kernels in the trace),
#: and with several matrices (a launch's work is not known).
ON_THE_CARD = {"spmv_roofline.single", "spmv_roofline.engine",
               "vector_gbps.single"}


@pytest.mark.parametrize("case", sorted(SMALL))
@pytest.mark.parametrize("trace", [False, True])
def test_a_small_run_is_correct(case, trace):
    cell = small_cell(case)
    out = run_cell(cell, seed=2 ** 31 + 17, seconds=0.5, trace=trace,
                   device="cpu", t_start=time.perf_counter())
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    metrics = cell.per_layer if trace else cell.end_to_end
    want = {m["name"] for m in metrics} - ON_THE_CARD
    assert set(out["metrics"]) == want
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert out["breakdown"]["device_ops"]
    json.dumps(out, allow_nan=False)


@pytest.mark.parametrize("case", ["mix.rhs_stream", "mix.engine_stream"])
def test_a_mix_sends_every_matrix(monkeypatch, case):
    cell = small_cell(case)
    seen = []
    judge = cell.program.judge

    def spy(cell, inputs, answers, *a):
        seen.extend(inputs.matrix_of(x.k) for x in answers)
        return judge(cell, inputs, answers, *a)

    monkeypatch.setattr(cell.program, "judge", spy)
    out = run_cell(cell, seed=11, seconds=0.3, trace=False, device="cpu",
                   t_start=time.perf_counter())
    assert out["correct"] and set(seen) == {0, 1}


def test_idle_share_counts_the_stretch_at_untraced_speed():
    """The traced stretch's host spans are counted at the window's mean
    for their name: a profiler that slows the host does not read as idle
    device time."""
    from harness.cell import Profile, Run
    prof = Profile(t0=0.0, window_s=3.0, ops=[("k", 0.0, 0.5)])
    run = Run(cell="c", config={}, inputs=None, setup_s=1.0, window_s=10.0,
              answers=[], spans={"window": {"solve": [1.0, 1.0, 1.0]},
                                 "traced": {"solve": [3.0]}},
              counters={}, profile=prof)
    assert run.traced_untraced_s() == 1.0
    for name in ("idle_pct.single", "idle_pct.engine"):
        read = load_cell("ecology2.rhs_stream" if name.endswith("single")
                         else "ecology2.engine_stream").readers[name]
        assert read(run) == pytest.approx(50.0)
    run.profile = None
    assert run.traced_untraced_s() is None


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a mix, a metric and a cell are files and entries:
    nothing else is edited."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = tmp_path / "bench"
    cfg = json.loads((b / "configs" / "ecology2_class.json").read_text())
    cfg.update(name="tiny_class",
               matrices=[{"generator": "poisson_2d", "nx": 6}])
    (b / "configs" / "tiny_class.json").write_text(json.dumps(cfg))
    (b / "traffic" / "two_warmups.json").write_text(json.dumps(
        {"entry": "solve", "warmup_solves": 2, "profile_seconds": 0.1,
         "reference_sample": 2}))
    (b / "metrics" / "answers.py").write_text(
        "def read(run):\n    return float(len(run.answers))\n")
    (b / "limits" / "tiny.two_warmups.json").write_text(json.dumps(
        {"true_rr_max": 1e-9}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_class", "source": "test",
                             "file": "bench/configs/tiny_class.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny.two_warmups",
                               "config": "tiny_class",
                               "traffic": "two_warmups", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "answers", "unit": "answers",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["tiny.two_warmups"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell("tiny.two_warmups", tmp_path)
    assert cell.traffic["warmup_solves"] == 2
    assert set(cell.readers) == {"answers", "setup_s"}
    out = run_cell(cell, seed=3, seconds=0.2, trace=False, device="cpu",
                   t_start=time.perf_counter())
    assert out["correct"] and out["metrics"]["answers"]["value"] > 0
    assert set(out["checks"]) == {"missing", "bad_status", "true_rr_max"}
    assert "answers" not in load_cell("ecology2.rhs_stream",
                                      tmp_path).readers


_ENTRY = """
import time
from harness.traffic import sync


class Entry:
    def __init__(self, program, inputs, mix, device, loop):
        self.program, self.inputs, self.device, self.loop = (
            program, inputs, device, loop)
        self.ops = [program.operator(a) for a in inputs.matrices]
        self.k = 0

    def run(self, until, phase):
        while True:
            m, b = self.inputs.request(self.k, self.device)
            t0 = time.perf_counter()
            res = self.program.solve(self.ops[m], b)
            sync(self.device)
            t1 = time.perf_counter()
            self.loop.span("call", t0, t1, phase)
            self.loop.answer(self.k, res, t1 - t0, phase)
            self.k += 1
            if until(t1, 1):
                return

    def drain(self, grace_s):
        pass

    def counters(self):
        return {"calls": self.k}

    def close(self):
        self.ops = None
"""

_PROGRAM = """
from pathlib import Path
from harness.spec import load_module

_base = load_module(Path(__file__).with_name("jpcg.py"))
make_inputs, Port, Control = _base.make_inputs, _base.Port, _base.Control
CALLS = []


def judge(*a):
    CALLS.append(len(a[2]))
    return _base.judge(*a)
"""


def test_a_new_entry_and_program_are_found_by_name(tmp_path):
    """A client loop and a system under test are files too."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = tmp_path / "bench"
    (b / "entries" / "one_by_one.py").write_text(_ENTRY)
    (b / "programs" / "jpcg_again.py").write_text(_PROGRAM)
    cfg = json.loads((b / "configs" / "ecology2_class.json").read_text())
    cfg.update(program="jpcg_again",
               matrices=[{"generator": "poisson_2d", "nx": 5}])
    (b / "configs" / "ecology2_class.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "rhs_stream.json").read_text())
    (b / "traffic" / "rhs_stream.json").write_text(json.dumps(
        {**mix, "entry": "one_by_one"}))
    cell = load_cell("ecology2.rhs_stream", tmp_path)
    assert cell.entry.__file__ == str((b / "entries" / "one_by_one.py")
                                      .resolve())
    out = run_cell(cell, seed=5, seconds=0.2, trace=True, device="cpu",
                   t_start=time.perf_counter())
    assert out["correct"] and cell.program.CALLS == [out["attempted"]]
    assert "iter_ms.single" in out["metrics"]


def test_benchmark_json_keeps_its_shape():
    """Names, units, keys and cross-references as the benchmark's contract
    fixes them, and every metric, configuration, mix and limit file where
    the harness looks for it."""
    import re
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    configs = {c["name"]: c for c in bench["configs"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert name.match(c["name"]) and (ROOT / c["file"]).is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert name.match(w["name"]) and w["config"] in configs
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        cell = load_cell(w["name"])
        names = set(cell.readers)
        assert "setup_s" in names and len({m["name"] for m in
                                           cell.end_to_end}) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert e2e[m["moves"]] in cell.end_to_end
