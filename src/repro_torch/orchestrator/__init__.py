"""repro_torch.orchestrator — multi-tenant preemption orchestrator.

The subsystem that makes the checkpoint mechanism *scheduler-driven*: N
concurrent checkpointable jobs under a priority scheduler with
preemption, heartbeat failure detection, straggler-triggered JIT dumps,
and τ*-adaptive checkpoint cadence — with every lifecycle transition
timestamped into a per-job recovery log so recovery time and goodput are
measurable per scenario.  A port of the JAX package's orchestrator; the
jobs run on ``cuda`` unless the caller passes ``device="cpu"``.

    from repro_torch.orchestrator import run_scenario

    summary = run_scenario("preemption", run_dir)
    assert summary["all_done"]
"""
from repro_torch.orchestrator.fleet import (FleetConfig, Replica,  # noqa: F401
                                            ServingFleet, run_fleet)
from repro_torch.orchestrator.job import (InvalidTransition,  # noqa: F401
                                          JobRecord, JobSpec, JobState,
                                          list_job_records)
from repro_torch.orchestrator.orchestrator import (  # noqa: F401
    MigrationPlan, Orchestrator, OrchestratorConfig)
from repro_torch.orchestrator.recovery import (GoodputMeter,  # noqa: F401
                                               RecoveryLog)
from repro_torch.orchestrator.scheduler import Decision, Scheduler  # noqa: F401
from repro_torch.orchestrator.signals import Signal, SignalChannel  # noqa: F401
from repro_torch.orchestrator.scenarios import (SCENARIOS,  # noqa: F401
                                                run_scenario, scenario_specs)
from repro_torch.orchestrator.workloads import (  # noqa: F401
    InterceptionWorkload, ServeWorkload, TrainWorkload, WorkloadConfig,
    make_workload_factory)
