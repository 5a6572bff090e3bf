"""The Schedule IR and its executor (the port's trimmed copies)."""
