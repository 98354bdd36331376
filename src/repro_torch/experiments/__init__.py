"""repro_torch.experiments — the JAX package's spec, scenario registry
and `run()` front door, for the port (paper and mesh drivers).

    from repro_torch.experiments import get_scenario, override, run
    result = run(override(get_scenario("low-bandwidth-int4"),
                          "run.rounds=3"))            # on the CUDA card
"""
from repro_torch.experiments.registry import (describe_scenarios,
                                              get_scenario, list_scenarios,
                                              register_scenario)
from repro_torch.experiments.runner import (SCHEMA_VERSION, Prepared,
                                            RunResult, build, default_out,
                                            run, run_prepared, sweep)
from repro_torch.experiments.spec import (AlgoSpec, DataSpec,
                                          ExperimentSpec, ModelSpec,
                                          ObsConfig, RunSpec, from_dict,
                                          override, to_dict)

__all__ = ["AlgoSpec", "DataSpec", "ExperimentSpec", "ModelSpec",
           "ObsConfig", "Prepared", "RunResult", "RunSpec",
           "SCHEMA_VERSION", "build", "default_out", "describe_scenarios",
           "from_dict", "get_scenario", "list_scenarios",
           "override", "register_scenario", "run", "run_prepared", "sweep",
           "to_dict"]
