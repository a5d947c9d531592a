from repro_torch.cluster.faults import FaultInjector, FaultSpec
from repro_torch.cluster.fleet import Fleet, paper_testbed, scale_fleet
from repro_torch.cluster.hardware import (NODE_CLASSES, PAPER_TESTBED,
                                          NodeClass)
from repro_torch.cluster.node import BackendNode, Instance, instance_bytes

__all__ = ["NodeClass", "NODE_CLASSES", "PAPER_TESTBED", "BackendNode",
           "Instance", "instance_bytes", "Fleet", "paper_testbed",
           "scale_fleet", "FaultInjector", "FaultSpec"]
