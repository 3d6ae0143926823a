"""One reader per metric: ``read(ctx)`` returns the metric's value, or None
where the run holds nothing for it to read."""
