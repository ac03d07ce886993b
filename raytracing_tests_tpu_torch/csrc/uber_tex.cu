// The textured instantiations of the persistent path tracer: uber.cu built
// with RT_UBER_TEX = 1, a library of its own (uber_tex.so) that compiles in
// parallel with the untextured one.
#define RT_UBER_TEX 1
#include "uber.cu"
