"""The V2X selection pipeline: twin, messages, fusion, prediction, radio, clustering, election."""
