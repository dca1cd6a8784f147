"""Model spec, table init, the score path, and weight carry-across."""
