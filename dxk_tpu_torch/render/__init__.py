"""The debug ray-caster (render/raster.py)."""
