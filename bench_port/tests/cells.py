"""The fit cell for the tests. `config2.fit` has its traffic file
(`workloads/fit.json`) and its metric readers, but no entry in
BENCHMARK.json and no limits file until the port's fused gradient agrees
with the reference (PERF.md, Open questions): its entry and limits are
made here."""

from bench_port import spec

# The reference in the program's place reads 0 on every number; these
# limits only have to lie under what a planted fault or the control reads.
FIT_LIMITS = {"loss_gap": 0.05, "grad_gap": 0.05, "step_gap": 0.05, "step_diff": 0.05}


def fit_cell() -> dict:
    bench = spec.load_benchmark()
    bench["workloads"].append({"name": "config2.fit", "config": "config2", "traffic": "fit", "chips": 1,
                               "why": "fit steps of make_fit_step"})
    return spec.cell(bench, "config2.fit", limits=dict(FIT_LIMITS))
