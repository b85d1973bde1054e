"""Core: the analytical model, the load, and the streaming simulator.

Modules:
  queueing   — the analytical model (Eq 1-8, fork-join bounds)
  arrivals   — piecewise-rate / trace arrival processes
  capacity   — Section-6 parameter tables, SLO solver, replica sizing
  simulator  — streaming (max,+) fork-join simulator, single replica
"""
