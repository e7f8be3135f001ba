"""idle_pct.engine: idle_pct.single's reading, in the engine's cells (it
moves systems_per_s there, not solve_ms)."""
from pathlib import Path

from harness.spec import load_module

read = load_module(Path(__file__).with_name("idle_pct.single.py")).read
