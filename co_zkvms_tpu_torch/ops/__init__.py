"""Field, curve, MSM, polynomial, sumcheck and PST13 operations."""
