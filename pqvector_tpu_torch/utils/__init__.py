"""Shared host utilities: stage timers and profiler traces, and the
fault-aware allocation of large host matrices."""
