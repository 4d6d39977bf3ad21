from repro_torch.ft.watchdog import (ElasticPlan, RestartPolicy, StragglerWatchdog,  # noqa: F401
                               plan_elastic_mesh)
from repro_torch.ft.inject import (InjectedCrash, arm_from_env, fault_point,  # noqa: F401
                             injected, register_points, registered_points)
