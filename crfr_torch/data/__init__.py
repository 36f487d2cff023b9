"""Host-side data: synthetic faces, packed records, the train pipeline."""
