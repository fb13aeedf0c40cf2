"""Analytic cost models of the port (the slice of ``repro/roofline`` the
scheduler's cost model needs)."""
