"""Training runtime: the trainer loop and its fault-tolerance primitives."""
from repro_torch.runtime.failure import (FailureInjector, HeartbeatMonitor,
                                         SimulatedFailure, StragglerDetector)
from repro_torch.runtime.trainer import Trainer, TrainerConfig
