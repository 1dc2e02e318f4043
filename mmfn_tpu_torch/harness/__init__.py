"""The closed loop: agents, the fake world, criteria, scoring and the phase0 CLI."""
