"""Vehicle motion and range-bearing measurement models."""
