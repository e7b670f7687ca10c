"""Developer tools of the port that run on the GPU (not imported by the
package)."""
