"""Plain PyTorch references of what the benchmark's cells run.  They import
nothing of the port and take nothing the port made: each works its inputs
out again from the seeds and laws the harness hands both sides."""
