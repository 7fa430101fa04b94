"""R1CS instances and the single-party Spartan prover."""
