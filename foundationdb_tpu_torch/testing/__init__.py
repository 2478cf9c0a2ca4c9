from foundationdb_tpu_torch.testing.workloads import (  # noqa: F401
    ApiCorrectnessWorkload, AtomicOpsWorkload, AttritionWorkload,
    ConflictRangeWorkload, ConsistencyCheckWorkload, CycleWorkload,
    IncrementWorkload, RandomCloggingWorkload, RandomMoveKeysWorkload,
    SelectorCorrectnessWorkload, SwizzleCloggingWorkload,
    VersionStampWorkload, WatchesWorkload, WriteDuringReadWorkload,
    run_spec)

from foundationdb_tpu_torch.testing.fuzz_workloads import (  # noqa: F401
    BackupUnderAttritionWorkload, ChangeConfigWorkload,
    FuzzApiCorrectnessWorkload, KillRegionWorkload,
    RemoveServersSafelyWorkload, RyowCorrectnessWorkload,
    SerializabilityWorkload)

from foundationdb_tpu_torch.testing.simulated_cluster import (  # noqa: F401
    FAST_SPECS, SLOW_SPECS, SPECS, ClusterDraw, RandomizedResult, Spec,
    SpecFailure, run_randomized_spec, sweep)
