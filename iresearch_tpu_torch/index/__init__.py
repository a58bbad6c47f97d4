"""The port's index: the segment reader and its residency on a torch device,
and the lifecycle (writer, reader, merge, consolidation), copies of the JAX
package's."""
