"""Test suite (a regular package, so an installed top-level `tests`
package cannot shadow it)."""
