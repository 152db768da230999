"""Masked SGD and learning-rate schedules."""
