"""Fault injection and fault tolerance of the port: the chaos sites'
schedule (``chaos``) and the single-host pieces of the reference's
training supervisor (``fault_tolerance``).  The elastic mesh runner needs
a mesh and is not ported."""
from . import chaos
from .chaos import Fault, FaultPlan
from .fault_tolerance import (ElasticPlan, HeartbeatMonitor, HostFailure,
                              TrainSupervisor, plan_elastic_mesh)

__all__ = ["ElasticPlan", "Fault", "FaultPlan", "HeartbeatMonitor",
           "HostFailure", "TrainSupervisor", "chaos", "plan_elastic_mesh"]
