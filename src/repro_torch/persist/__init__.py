"""Persistence of the port.  So far only the serve engine's fault plan
(``faultfs.EngineFaultPlan``, ``faultfs.CrashError``); the checkpoint
format, the write-ahead log, recovery and the filesystem shims
(``OsIO``/``FaultIO``) come with ROADMAP A6."""
from .faultfs import CrashError, EngineFaultPlan

__all__ = ["CrashError", "EngineFaultPlan"]
