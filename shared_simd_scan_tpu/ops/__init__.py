"""Compute ops: the scan tiers, their drivers and the pure-jnp oracles."""
