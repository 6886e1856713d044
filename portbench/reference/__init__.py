"""The plain reference of the benchmark's comparison (bilstm.py)."""
