"""MSM stack: clustering, counting, estimation, free energy."""
