"""Static analysis of the port (counterpart of luminaai_tpu/analysis/):
astlint.py, the source rules, and trace_audit.py, the audits over what
the port dispatches."""
