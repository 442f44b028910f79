"""Interop with go-libp2p-pubsub's trace tooling: ``export`` writes a
simulator run as the reference tracer's event stream (13 event types, pb
or ndjson), ``replay`` reads such a file back and rebuilds the final
possession and mesh from it."""
