"""Simulator core: trace IR, timing engine, memory model, suite."""
