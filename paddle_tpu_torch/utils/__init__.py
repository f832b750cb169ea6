"""Host utilities of the port: `faults`, the deterministic fault
injection of the chaos drills."""
