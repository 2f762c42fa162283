"""Scene model and the stage-1 render."""
