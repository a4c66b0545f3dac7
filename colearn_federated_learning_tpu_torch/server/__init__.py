"""Server side: cohort sampling, aggregation and the round driver."""
