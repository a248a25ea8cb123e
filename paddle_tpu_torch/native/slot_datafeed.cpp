// A verbatim copy of paddle_tpu/native/slot_datafeed.cpp: host C++ (no device
// code), built for the port by paddle_tpu_torch/native/__init__.py.
//
// Native slot-file DataFeed parser.
//
// Capability analog of the reference's C++ data ingestion
// (paddle/fluid/framework/data_feed.cc MultiSlotDataFeed::ParseOneInstance
// and data_set.cc LoadIntoMemory): parsing CTR-style slot files off the
// Python thread at C speed, exposed to Python over a C ABI (ctypes), per
// the repo's no-pybind11 constraint.
//
// File format (one example per line):
//   label<TAB or SPACE>slot_id:feasign[,feasign...] ...
// e.g.  "1 0:1001,1002 1:55 3:7"
// Slots absent from a line are empty for that example. Feasigns are
// uint64-range ints stored as int64 (the reference's feasign type,
// data_feed.h:108). Output layout is CSR per slot: offsets[n+1] +
// concatenated values, which maps directly onto the host-side sparse
// lookup path (SelectedRows analog).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct SlotData {
  int64_t n_examples = 0;
  int num_slots = 0;
  std::vector<float> labels;
  // per slot: CSR offsets (n_examples+1) and values
  std::vector<std::vector<int64_t>> offsets;
  std::vector<std::vector<int64_t>> values;
  std::string error;
};

}  // namespace

extern "C" {

// Parse `path` expecting slot ids in [0, num_slots). Returns an opaque
// handle (never null); check sf_error() for parse failures.
void* sf_parse(const char* path, int num_slots) {
  auto* d = new SlotData();
  d->num_slots = num_slots;
  d->offsets.assign(num_slots, {0});
  d->values.assign(num_slots, {});

  FILE* f = std::fopen(path, "rb");
  if (!f) {
    d->error = std::string("cannot open ") + path;
    return d;
  }
  std::string line;
  char buf[1 << 16];
  while (std::fgets(buf, sizeof(buf), f)) {
    line.assign(buf);
    while (!line.empty() && (line.back() == '\n' || line.back() == '\r'))
      line.pop_back();
    if (line.empty()) continue;
    const char* p = line.c_str();
    char* end = nullptr;
    float label = std::strtof(p, &end);
    if (end == p) {
      d->error = "bad label in line: " + line.substr(0, 80);
      break;
    }
    d->labels.push_back(label);
    p = end;
    // tokens: slot:feasign[,feasign...]
    std::vector<char> seen(num_slots, 0);
    while (*p) {
      while (*p == ' ' || *p == '\t') ++p;
      if (!*p) break;
      long slot = std::strtol(p, &end, 10);
      if (end == p || *end != ':') {
        d->error = "bad slot token in line: " + line.substr(0, 80);
        break;
      }
      p = end + 1;
      if (slot < 0 || slot >= num_slots) {
        // unknown slot: skip its values (forward compat)
        while (*p && *p != ' ' && *p != '\t') ++p;
        continue;
      }
      auto& vals = d->values[slot];
      while (true) {
        long long v = std::strtoll(p, &end, 10);
        if (end == p) break;
        vals.push_back(static_cast<int64_t>(v));
        p = end;
        if (*p == ',') { ++p; continue; }
        break;
      }
      seen[slot] = 1;
    }
    if (!d->error.empty()) break;
    ++d->n_examples;
    for (int s = 0; s < num_slots; ++s)
      d->offsets[s].push_back(static_cast<int64_t>(d->values[s].size()));
  }
  std::fclose(f);
  if (!d->error.empty()) {
    d->n_examples = 0;
  }
  return d;
}

const char* sf_error(void* h) {
  auto* d = static_cast<SlotData*>(h);
  return d->error.empty() ? nullptr : d->error.c_str();
}

int64_t sf_num_examples(void* h) {
  return static_cast<SlotData*>(h)->n_examples;
}

const float* sf_labels(void* h) {
  return static_cast<SlotData*>(h)->labels.data();
}

int64_t sf_slot_size(void* h, int slot) {
  return static_cast<int64_t>(
      static_cast<SlotData*>(h)->values[slot].size());
}

const int64_t* sf_slot_offsets(void* h, int slot) {
  return static_cast<SlotData*>(h)->offsets[slot].data();
}

const int64_t* sf_slot_values(void* h, int slot) {
  return static_cast<SlotData*>(h)->values[slot].data();
}

void sf_free(void* h) { delete static_cast<SlotData*>(h); }

}  // extern "C"
