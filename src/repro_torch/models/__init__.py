"""Models: the paper-experiment image models (`cnn`) and the
transformer family of the serve path (`layers`, `recurrent`,
`transformer`)."""
