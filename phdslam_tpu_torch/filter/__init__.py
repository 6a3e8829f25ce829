"""Filter state, prediction, update, step and estimates."""
