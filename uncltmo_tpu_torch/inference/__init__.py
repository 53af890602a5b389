"""Tiled inference: plan, engine, runner."""
