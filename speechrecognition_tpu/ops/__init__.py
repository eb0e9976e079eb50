"""Numeric building blocks: double-float (two-f32) arithmetic."""
