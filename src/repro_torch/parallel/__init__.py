"""Flat-buffer bucketing of parameter trees."""
