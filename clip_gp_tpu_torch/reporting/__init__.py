"""Results aggregation and cross-experiment bar plots, copied from the JAX
package's ``reporting/`` with their import paths changed."""
