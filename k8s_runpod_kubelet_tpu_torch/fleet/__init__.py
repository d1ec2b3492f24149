"""Fleet membership of a torch serving replica (the replica half of the
JAX package's ``fleet/``; the router, registry and autoscaler are the JAX
package's framework-free tier)."""
