"""The serving layer: the retrieval service, its admission pipeline,
durability (journal + snapshots) and the maintenance loop."""
