from .fault_tolerance import LoopReport, ResilientLoop, StragglerMonitor
