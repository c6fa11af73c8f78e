"""Request traces and the training token pipeline (copied from the reference
package)."""
