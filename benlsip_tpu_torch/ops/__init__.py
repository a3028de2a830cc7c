"""Constraint algebra: polyhedra, active sets, projections, AL evaluation."""
